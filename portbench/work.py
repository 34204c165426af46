"""The work of the step's functions, counted from shapes, and the card's
peaks: the yardstick of the rooflines and of the step's MFU.

FLOPs count a product's multiply-adds twice. A backward takes twice its
forward's products, less the input gradient of a first layer whose input
is data (the bags need none); no product is counted twice for a recompute.
Bytes count each input read once and each output written once.

``k2_flops`` and ``k3_flops`` are the two kernels' operation counts as the
kernel table of ``PERF.md`` gives them (K3's includes its recompute of the
forward's trunk and gates); the rooflines take the function's forward and
backward instead, :func:`clam_flops`, which a design without the recompute
could reach.
"""

from __future__ import annotations

# Published H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): products
# by type, FLOP/s, and HBM bytes/s. float32 products count at TF32's rate,
# the tensor cores' fastest for f32 operands.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
HBM_BPS = 3.35e12
F32 = 4


def k2_flops(bags: int, n: int, fin: int, l1: int, d: int) -> float:
    """K2 (the fused trunk, gates and pool forward) as ``PERF.md``'s kernel
    table counts it: trunk ``2 R Fin L1``, two gates ``4 R L1 D``, pool ``2 R L1``."""
    r = bags * n
    return 2 * r * fin * l1 + 4 * r * l1 * d + 2 * r * l1


def k3_flops(bags: int, n: int, fin: int, l1: int, d: int) -> float:
    """K3 (the backward, recomputing trunk and gates) as ``PERF.md`` counts
    it: twice the trunk, three times the gates, the pool."""
    r = bags * n
    return 2 * (2 * r * fin * l1) + 3 * (4 * r * l1 * d) + 2 * r * l1


def clam_flops(bags: int, n: int, fin: int, l1: int, d: int, gated: bool = True) -> float:
    """CLAM_SB's aggregator, forward and backward: trunk, gates, scores, pool."""
    r, g = bags * n, 2 if gated else 1
    fwd = 2 * r * fin * l1 + 2 * g * r * l1 * d + 2 * r * d + 2 * r * l1
    return 3 * fwd - 2 * r * fin * l1


def abmil_flops(bags: int, n: int, fin: int, big: int, d: int) -> float:
    """ABMIL's aggregator, forward and backward: three encoder layers, the
    scorer, the pool and the decoder on the pooled rows."""
    r = bags * n
    fwd = (2 * r * fin * big + 2 * (2 * r * big * big) + 2 * r * big * d + 2 * r * d
           + 2 * r * big + 2 * bags * big * big)
    return 3 * fwd - 2 * r * fin * big


def aggregator_flops(cfg: dict, bags: int, n: int) -> float:
    if cfg["arch"] == "CLAM_SB":
        return clam_flops(bags, n, cfg["dim_in"], cfg["L1"], cfg["D"], cfg["gate"])
    return abmil_flops(bags, n, cfg["dim_in"], cfg["L"], cfg["D"])


def aggregator_bytes(cfg: dict, bags: int, n: int, params: int) -> float:
    """The bags read once, the weights read once and their gradients written
    once (f32)."""
    return F32 * (bags * n * cfg["dim_in"] + 2 * params)


def gru_flops(rows: int, x: int, h: int, out: int) -> float:
    """One GRU cell step and its linear output, forward."""
    return 2 * rows * (x * 3 * h + h * 3 * h + h * out)


def ntxent_flops(b: int, c: int) -> float:
    """NT-Xent's similarity matrix over ``2B`` rows, forward."""
    return 2 * (2 * b) ** 2 * c


def policy_flops(rows: int, s: int, h: int, k: int) -> float:
    """The policy's act, forward: state encoder, GRU cell, actor."""
    return 2 * rows * (s * 2048 + 2048 * h + h * 3 * h + h * 3 * h + h * k)


def step_flops(cfg: dict, traffic: dict) -> float:
    """The model FLOPs of one optimizer step: the aggregator over all of the
    step's bags, the GRU head and NT-Xent at each of T steps for both views,
    forward and backward; in stage 3 the policy's acts, forward only."""
    t, b, n = traffic["T"], traffic["batch"], traffic["feat_size"]
    f = cfg["L1"] if cfg["arch"] == "CLAM_SB" else cfg["L"]
    flops = aggregator_flops(cfg, t * 2 * b, n)
    flops += 3 * 2 * t * gru_flops(b, f, cfg["fc_hidden_dim"], cfg["projection_dim"])
    flops += 3 * t * ntxent_flops(b, cfg["projection_dim"])
    if traffic["stage"] != 1:
        flops += 2 * (t - 1) * policy_flops(b, f, cfg["policy_hidden_dim"],
                                            traffic["num_clusters"])
    return flops


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the products at the
    dtype's peak and the bytes at HBM's rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BPS)


def aggregator_roofline(run) -> "float | None":
    """The aggregator's share of its roofline in a traced run: its bound
    over the device time of the events the ``portbench.aggregator`` spans
    caused, per step, in %; None where the spans caused none."""
    from portbench.trace import busy_union_ms

    events = run.caused_by("portbench.aggregator")
    if not events:
        return None
    cfg, tr = run.cfg, run.traffic
    bags, n = tr["T"] * 2 * tr["batch"], tr["feat_size"]
    bound = bound_s(aggregator_flops(cfg, bags, n),
                    aggregator_bytes(cfg, bags, n, run.agg_params), cfg["compute_dtype"])
    return 100.0 * bound / (busy_union_ms(events) / 1e3 / run.steps)
