"""Plain PyTorch reference of MuRCL pretraining's arithmetic, in float32.

Written from the published descriptions (MuRCL, Zhu et al., IEEE TMI 2023;
CLAM, Lu et al., Nat. Biomed. Eng. 2021; ABMIL, Ilse et al., ICML 2018;
SimCLR's NT-Xent; Adam with L2 weight decay as ``torch.optim.Adam`` takes
it) and from no code of the program under test: it imports nothing of
``murcl_tpu_torch`` and takes nothing the program derived. Every product
goes through :meth:`Reference.mm`, which with ``tf32=True`` rounds both
operands to TF32 (10 mantissa bits, to nearest, ties away from zero) before
an f32 product: the control, the same arithmetic one precision down.

Parameters live in plain dicts keyed by the published checkpoint layout
(the reference ``CLAM_SB``, ``ABMIL``, ``Full_layer`` and ``ActorCritic``
``state_dict`` keys), so the benchmark can load the same numbers into the
program's modules by name and the reference keeps its own copy.

Dropout keeps an element when a 32-bit counter hash of ``(seed, bag,
stream, row, col)`` is at least ``rate * 2**32`` and scales it by ``1 / (1 -
rate)``: stream 0 the trunk's output, 1 and 2 the two gates; ``bag`` is the
bag's index in the aggregator call, and the row stride is the layer's width.
The hash is murmur3's 32-bit finaliser over ``seed ^ (4 bag + stream + 1) *
0x9e3779b1`` and ``(row * width + col) * 0x7feb352d``: a guarantee of the
configuration (the masks are a function of the seed), recomputed here.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

M32 = 0xFFFFFFFF


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, ties away from zero."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -8192).view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """``a @ b`` with both operands rounded to TF32, and so each product of
    its backward."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = to_tf32(a), to_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


def tf32_product(a, b):
    """``a @ b`` as TF32 takes it (a leading batch of ``a`` broadcast over
    a matrix ``b``, or a batch of matching shape)."""
    return _TF32Product.apply(a, b)


# ---------------------------------------------------------------------------
# parameter layouts
# ---------------------------------------------------------------------------

def aggregator_leaves(cfg: dict) -> List[Tuple[str, tuple]]:
    """``(name, shape)`` of the aggregator's leaves, under the ``encoder.``
    prefix of the contrastive wrapper, in module order."""
    fin, c = cfg["dim_in"], cfg["projection_dim"]
    if cfg["arch"] == "CLAM_SB":
        l1, d = cfg["L1"], cfg["D"]
        att = "encoder.attention_net.3."
        out = [("encoder.attention_net.0.weight", (l1, fin)),
               ("encoder.attention_net.0.bias", (l1,)),
               (att + "attention_a.0.weight", (d, l1)), (att + "attention_a.0.bias", (d,))]
        if cfg["gate"]:
            out += [(att + "attention_b.0.weight", (d, l1)), (att + "attention_b.0.bias", (d,))]
        out += [(att + "attention_c.weight", (1, d)), (att + "attention_c.bias", (1,)),
                ("encoder.classifiers.weight", (c, l1)), ("encoder.classifiers.bias", (c,))]
        for i in range(c):
            out += [(f"encoder.instance_classifiers.{i}.weight", (2, l1)),
                    (f"encoder.instance_classifiers.{i}.bias", (2,))]
        return out
    if cfg["arch"] == "ABMIL":
        big, d = cfg["L"], cfg["D"]
        out = []
        for i, w_in in zip((0, 3, 6), (fin, big, big)):
            out += [(f"encoder.encoder.{i}.weight", (big, w_in)),
                    (f"encoder.encoder.{i}.bias", (big,))]
        return out + [("encoder.attention.0.weight", (d, big)), ("encoder.attention.0.bias", (d,)),
                      ("encoder.attention.2.weight", (1, d)), ("encoder.attention.2.bias", (1,)),
                      ("encoder.decoder.0.weight", (big, big)), ("encoder.decoder.0.bias", (big,)),
                      ("encoder.fc.weight", (c, big)), ("encoder.fc.bias", (c,))]
    raise ValueError(f"no reference for arch {cfg['arch']!r}")


def embed_width(cfg: dict) -> int:
    return cfg["L1"] if cfg["arch"] == "CLAM_SB" else cfg["L"]


def head_leaves(cfg: dict) -> List[Tuple[str, tuple]]:
    f, h, c = embed_width(cfg), cfg["fc_hidden_dim"], cfg["projection_dim"]
    return [("rnn.weight_ih_l0", (3 * h, f)), ("rnn.weight_hh_l0", (3 * h, h)),
            ("rnn.bias_ih_l0", (3 * h,)), ("rnn.bias_hh_l0", (3 * h,)),
            ("fc.weight", (c, h)), ("fc.bias", (c,))]


def policy_leaves(cfg: dict, k: int) -> List[Tuple[str, tuple]]:
    s, h = embed_width(cfg), cfg["policy_hidden_dim"]
    return [("state_encoder.0.weight", (2048, s)), ("state_encoder.0.bias", (2048,)),
            ("state_encoder.2.weight", (h, 2048)), ("state_encoder.2.bias", (h,)),
            ("gru.weight_ih_l0", (3 * h, h)), ("gru.weight_hh_l0", (3 * h, h)),
            ("gru.bias_ih_l0", (3 * h,)), ("gru.bias_hh_l0", (3 * h,)),
            ("actor.0.weight", (k, h)), ("actor.0.bias", (k,)),
            ("critic.0.weight", (1, h)), ("critic.0.bias", (1,))]


# ---------------------------------------------------------------------------
# the dropout hash
# ---------------------------------------------------------------------------

def _times(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32), in two 16-bit halves
    of ``c`` so that no product leaves int64."""
    return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def _finalise(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser."""
    h = h ^ (h >> 16)
    h = _times(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _times(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def keep_mask(seed: int, bag0: int, bags: int, rows: int, cols: int, stream: int,
              rate: float, device) -> torch.Tensor:
    """Bool ``(bags, rows, cols)``: which units of bags ``bag0 ..`` dropout keeps."""
    i = torch.arange(bag0, bag0 + bags, device=device, dtype=torch.int64)
    key = _finalise((seed & M32) ^ _times(4 * i + stream + 1, 0x9E3779B1))
    pos = torch.arange(rows * cols, device=device, dtype=torch.int64)
    bits = _finalise(key[:, None] ^ _times(pos, 0x7FEB352D)[None, :])
    return (bits >= min(M32, int(rate * 2 ** 32))).reshape(bags, rows, cols)


# ---------------------------------------------------------------------------
# sub-bag selection and mixup
# ---------------------------------------------------------------------------

def windows(num_patches, cluster_sizes, actions, feat_size: int):
    """Each cluster's window ``[start, end)`` in its patch list, as python's
    ``lst[l:l+s]`` takes it: ``s = round(n_c F / N)`` (half to even), ``l =
    floor(a_c (n_c - s))``, in f32 as the published code takes them."""
    n_c = cluster_sizes.to(torch.float32)
    ratio = feat_size / num_patches.to(torch.float32)
    s = torch.round(n_c * ratio[:, None]).to(torch.int64)
    lo = torch.floor(actions * (n_c - s.to(torch.float32))).to(torch.int64)
    hi = lo + s
    n = cluster_sizes.to(torch.int64)

    def bound(v):
        return torch.where(v < 0, (n + v).clamp_min(0), torch.minimum(v, n))

    return bound(lo), bound(hi)


def sub_bags(feats, offsets, num_patches, patch_cluster, patch_pos, cluster_sizes,
             slide_ids, actions, feat_size: int) -> torch.Tensor:
    """``(B, feat_size, D)``: each bag's selected patches in ascending patch
    order, cut at ``feat_size`` rows and zero-padded past its count."""
    start, end = windows(num_patches[slide_ids], cluster_sizes[slide_ids], actions, feat_size)
    cl = patch_cluster[slide_ids]
    pos = patch_pos[slide_ids]
    live = pos >= 0
    c = cl.clamp_min(0)
    take = live & (pos >= start.gather(1, c)) & (pos < end.gather(1, c))
    n_max = take.shape[1]
    cols = torch.arange(n_max, device=take.device).expand_as(take)
    # selected patches first, each group in patch order (a stable sort)
    order = torch.sort(torch.where(take, cols, cols + n_max), dim=1, stable=True).values
    order = order[:, :feat_size] % n_max if n_max >= feat_size else \
        torch.cat([order % n_max, order.new_zeros((order.shape[0], feat_size - n_max))], 1)
    kept = torch.arange(feat_size, device=take.device)[None, :] < take.sum(1, keepdim=True)
    rows = feats[offsets[slide_ids][:, None] + torch.where(kept, order, 0)]
    return torch.where(kept[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))


def mix(x, perm, lam):
    """``lam_i x_i + (1 - lam_i) x_{perm_i}``, ``1 - lam`` in f32."""
    lam = lam.to(torch.float32).reshape(-1, *([1] * (x.dim() - 1)))
    return lam * x + (1.0 - lam) * x[perm]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class Reference:
    """The step's arithmetic over parameter dicts, ``tf32`` the control's
    products."""

    def __init__(self, cfg: dict, tf32: bool = False):
        self.cfg = cfg
        self.tf32 = tf32

    def mm(self, a, b):
        return tf32_product(a, b) if self.tf32 else a @ b

    def linear(self, x, w, b):
        return self.mm(x, w.t()) + b

    # -- aggregators: (nb, N, Fin) bags -> (nb, F) embeddings ------------
    def clam(self, p, x, seed: int, bag0: int, training: bool = True):
        cfg = self.cfg
        att = "encoder.attention_net.3."
        rate = cfg["dropout"] if training else 0.0
        nb, n, _ = x.shape

        def drop(v, stream):
            if rate == 0:
                return v
            keep = keep_mask(seed, bag0, nb, n, v.shape[-1], stream, rate, v.device)
            scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32, device=v.device)
            return torch.where(keep, v * scale, torch.zeros((), device=v.device))

        xc = drop(torch.relu(self.linear(x, p["encoder.attention_net.0.weight"],
                                         p["encoder.attention_net.0.bias"])), 0)
        u = drop(torch.tanh(self.linear(xc, p[att + "attention_a.0.weight"],
                                        p[att + "attention_a.0.bias"])), 1)
        if cfg["gate"]:
            u = u * drop(torch.sigmoid(self.linear(xc, p[att + "attention_b.0.weight"],
                                                   p[att + "attention_b.0.bias"])), 2)
        s = self.mm(u, p[att + "attention_c.weight"].t())[..., 0] + p[att + "attention_c.bias"]
        w = torch.softmax(s, dim=-1)
        return self.mm(w[:, None, :], xc)[:, 0]

    def abmil(self, p, x):
        h = x
        for i in (0, 3, 6):
            h = torch.relu(self.linear(h, p[f"encoder.encoder.{i}.weight"],
                                       p[f"encoder.encoder.{i}.bias"]))
        a = torch.tanh(self.linear(h, p["encoder.attention.0.weight"],
                                   p["encoder.attention.0.bias"]))
        s = self.mm(a, p["encoder.attention.2.weight"].t())[..., 0] + p["encoder.attention.2.bias"]
        w = torch.softmax(s, dim=-1)
        m = self.mm(w[:, None, :], h)[:, 0]
        m = m * (1.0 / torch.sqrt(torch.tensor(float(x.shape[1]), device=x.device)))
        return torch.relu(self.linear(m, p["encoder.decoder.0.weight"],
                                      p["encoder.decoder.0.bias"]))

    def aggregate(self, p, x, seed: int, bag0: int):
        if self.cfg["arch"] == "CLAM_SB":
            return self.clam(p, x, seed, bag0)
        return self.abmil(p, x)

    # -- GRU cells, the projection head, the policy ----------------------
    def gru(self, p, pre, x, h):
        i_r, i_z, i_n = self.linear(x, p[pre + "weight_ih_l0"], p[pre + "bias_ih_l0"]).chunk(3, -1)
        h_r, h_z, h_n = self.linear(h, p[pre + "weight_hh_l0"], p[pre + "bias_hh_l0"]).chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h

    def head(self, p, x, h=None):
        """``(projection, new hidden)``; ``h=None`` starts from zeros."""
        if h is None:
            h = x.new_zeros((x.shape[0], self.cfg["fc_hidden_dim"]))
        h = self.gru(p, "rnn.", x, h)
        return self.linear(h, p["fc.weight"], p["fc.bias"]), h

    def policy_mean(self, p, state, h):
        """The actor's mean action and the policy's new hidden state."""
        e = torch.relu(self.linear(state, p["state_encoder.0.weight"], p["state_encoder.0.bias"]))
        e = torch.relu(self.linear(e, p["state_encoder.2.weight"], p["state_encoder.2.bias"]))
        h = self.gru(p, "gru.", e, h)
        return torch.sigmoid(self.linear(h, p["actor.0.weight"], p["actor.0.bias"])), h

    # -- NT-Xent -----------------------------------------------------------
    def nt_xent(self, a, b, temperature: float):
        z = torch.cat([a, b])
        zn = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(1e-8)
        sim = self.mm(zn, zn.t()) / temperature
        n = z.shape[0]
        idx = torch.arange(n, device=z.device)
        off = sim.masked_fill(idx[:, None] == idx[None, :], float("-inf"))
        return (torch.logsumexp(off, dim=1) - sim[idx, (idx + n // 2) % n]).mean()


def adam_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              state: Dict[str, list], lrs: Dict[str, float], t: int, beta1: float,
              beta2: float, wd: float, eps: float = 1e-8) -> Dict[str, torch.Tensor]:
    """One Adam step with L2 decay added to the gradient (not AdamW); a
    parameter without a gradient takes a zero one. Returns the gradients as
    the moments took them; updates ``params`` and ``state`` in place."""
    seen = {}
    c1, c2 = 1.0 - beta1 ** t, 1.0 - beta2 ** t
    for name, w in params.items():
        g = grads.get(name)
        g = (torch.zeros_like(w) if g is None else g) + wd * w
        m, v = state.setdefault(name, [torch.zeros_like(w), torch.zeros_like(w)])
        m.mul_(beta1).add_(g, alpha=1.0 - beta1)
        v.mul_(beta2).add_(g * g, alpha=1.0 - beta2)
        w.sub_(lrs[name] / c1 * m / ((v / c2).sqrt() + eps))
        seen[name] = g
    return seen


def init_scale(shape: tuple) -> float:
    """The benchmark's weights: std ``sqrt(2 / (fan_in + fan_out))`` for a
    matrix (Xavier's normal), 0.01 for a vector."""
    if len(shape) == 1:
        return 0.01
    return math.sqrt(2.0 / (shape[0] + shape[1]))
