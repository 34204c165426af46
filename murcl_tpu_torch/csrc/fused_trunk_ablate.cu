// The ablations of K2 and K3 (murcl_fused_trunk_fwd_ablate,
// murcl_fused_trunk_bwd_ablate). Replace scripts/dbg_bwd_ablate.py run_bwd
// (:152) and dbg_vpu_lean.py run_fwd (:122) and run_bwd (:280), the JAX
// package's TPU probes that split K2/K3's time by part: fused_trunk.cu's
// passes with some left out (nowgrad, nodx, recompute), or with an
// epilogue's elementwise chain taken apart (pre-lean) or its dx summed once
// (lean2), through kernels of their own names (X_ablate_wg) that run the
// production kernels' bodies (fused_trunk.cuh) at another variant. They are
// measurement probes, off every training path; what bounds each is what
// bounds the production pass it keeps. Their own source, so that their
// instantiations build beside the production kernels, not after them.
#include "fused_trunk.cuh"

namespace {

template <typename T, int V>
__global__ void __launch_bounds__(wg::THREADS, 1) trunk_ablate_wg(TRUNK_PARAMS(KMAP)) {
  trunk_body<T, V>(TRUNK_ARGS);
}

template <typename T, int V>
__global__ void __launch_bounds__(wg::THREADS, 1) gates_fwd_ablate_wg(GATES_FWD_PARAMS(KMAP)) {
  gates_fwd_body<T, V>(GATES_FWD_ARGS);
}

template <typename T, int V>
__global__ void __launch_bounds__(wg::THREADS, 1) gates_bwd_ablate_wg(GATES_BWD_PARAMS(KMAP)) {
  gates_bwd_body<T, V>(GATES_BWD_ARGS);
}

template <typename T, int V>
__global__ void __launch_bounds__(wg::THREADS, 1) dx_ablate_wg(DX_PARAMS(KMAP)) {
  dx_body<T, V>(DX_ARGS);
}

// The kernels of variant V's passes, T's: kPreLean swaps every pass with
// an elementwise chain, kDwcOnly the gate backward, kLean2 (bf16) dx; the
// others, null, are the production kernels (kLean2 changes nothing in f32,
// whose dx has one accumulator already).
template <typename T, int V>
TrunkKernels kernels() {
  TrunkKernels k;
  if constexpr (V == kPreLean) {
    k.trunk = (const void*)&trunk_ablate_wg<T, V>;
    k.gates_fwd = (const void*)&gates_fwd_ablate_wg<T, V>;
    k.gates_bwd = (const void*)&gates_bwd_ablate_wg<T, V>;
    k.dx = (const void*)&dx_ablate_wg<T, V>;
  } else if constexpr (V == kDwcOnly) {
    k.gates_bwd = (const void*)&gates_bwd_ablate_wg<T, V>;
  } else if constexpr (V == kLean2 && !kX3<T>) {
    k.dx = (const void*)&dx_ablate_wg<T, V>;
  }
  return k;
}

template <int V>
TrunkKernels variant_kernels(int is_bf16) {
  return is_bf16 ? kernels<bf16, V>() : kernels<float, V>();
}

}  // namespace

// The ablations of K2 (the port of scripts/dbg_vpu_lean.py run_fwd):
// murcl_fused_trunk_fwd's arguments after `variant`, 0 the production
// kernels (lean), 1 the pre-lean epilogues (kPreLean).
MURCL_API int murcl_fused_trunk_fwd_ablate(int variant, TRUNK_FWD_API_PARAMS) {
  switch (variant) {
    case 0: return fused_trunk_fwd_with(TrunkKernels{}, TRUNK_FWD_API_ARGS);
    case 1: return fused_trunk_fwd_with(variant_kernels<kPreLean>(is_bf16), TRUNK_FWD_API_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

// The ablations of K3 (the ports of scripts/dbg_bwd_ablate.py and
// dbg_vpu_lean.py run_bwd): murcl_fused_trunk_bwd's arguments after
// `variant`: 0 the production kernels and passes (full; nodrop is 0 with
// use_dropout 0), 1 nowgrad (kSkipWgrad), 2 nodx (kSkipDx), 3 recompute (the
// trunk, the softmax backward and kDwcOnly's gate pass: dwc and dbc alone),
// 4 pre-lean (kPreLean), 5 lean2 (kLean2). The outputs a variant skips stay
// zero; dh as in murcl_fused_trunk_bwd (none in nodx and recompute).
MURCL_API int murcl_fused_trunk_bwd_ablate(int variant, TRUNK_BWD_API_PARAMS) {
  switch (variant) {
    case 0: return fused_trunk_bwd_with(TrunkKernels{}, 0, TRUNK_BWD_API_ARGS);
    case 1: return fused_trunk_bwd_with(TrunkKernels{}, kSkipWgrad, TRUNK_BWD_API_ARGS);
    case 2: return fused_trunk_bwd_with(TrunkKernels{}, kSkipDx, TRUNK_BWD_API_ARGS);
    case 3:
      return fused_trunk_bwd_with(variant_kernels<kDwcOnly>(is_bf16), kSkipWgrad | kSkipDx,
                                  TRUNK_BWD_API_ARGS);
    case 4: return fused_trunk_bwd_with(variant_kernels<kPreLean>(is_bf16), 0, TRUNK_BWD_API_ARGS);
    case 5: return fused_trunk_bwd_with(variant_kernels<kLean2>(is_bf16), 0, TRUNK_BWD_API_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}
