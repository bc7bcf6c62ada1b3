"""Roofline terms of a COPML step, and of an LM step, on NVIDIA H100 (SXM)
cards.

Per (shape x mesh):
  compute term    = ops / (chips * FIELD_OPS_PER_S)
  memory term     = bytes / (chips * HBM_BYTES_PER_S)
  collective term = collective bytes a device sends / the link's rate

Two counts are kept apart.  Executed work (`ops`, `bytes`) is summed over
the field kernels' launches (launch/launch_counter.py), each launch priced
from its shapes by `gemm_work`, `gradient_work`, `fused_work` and
`poly_work`: every input read once, every output written once, 2
operations a field multiply-add.  Useful work (`model_ops`) comes from the
protocol's shapes alone (`copml_model_ops`), so it reads the same whatever
kernel implements the step.

The elementwise torch ops of a step (the threefry emulation, field adds)
are not field-kernel launches and are not counted.

An LM step (`lm_prefill_work`, `lm_decode_work`, `lm_train_work`,
`lm_bound`) is priced from its config and shapes (`model_flops` is the
JAX package's useful-work count): bytes are every weight the step needs
read once (an MoE layer's experts only as many as its tokens can route
to, min(n_experts, tokens x top_k)), the K/V and state caches written
(prefill) or read (decode: the whole cache, as decode_attention reads
it), and operations are 2 a multiply-add of its matrix products at
BF16_FLOPS_PER_S.
"""

from __future__ import annotations

import dataclasses

# --- the card: NVIDIA H100 SXM5 80 GB --------------------------------------
#: HBM3 bandwidth (NVIDIA H100 Tensor Core GPU datasheet, SXM5: 3.35 TB/s)
HBM_BYTES_PER_S = 3.35e12
#: streaming multiprocessors (NVIDIA H100 Tensor Core GPU Architecture
#: whitepaper, H100 SXM5: 132 SMs)
SMS = 132
#: INT32 lanes a SM issues a clock (the same whitepaper: 16 INT32 units in
#: each of the SM's 4 partitions; FP32 has 32 there, i.e. twice the lanes)
INT32_LANES_PER_SM = 64
#: boost clock (`nvidia-smi --query-gpu=clocks.max.sm` on an H100 SXM5:
#: 1980 MHz; chip_smoke.py logs it beside every run)
BOOST_CLOCK_HZ = 1.98e9
#: 32-bit integer instructions a second, one a lane a clock: 16.73e12
INT32_INST_PER_S = SMS * INT32_LANES_PER_SM * BOOST_CLOCK_HZ
#: how a field multiply-add is priced: the kernels accumulate x*y (x, y <
#: p < 2^26) into a 64-bit sum with one IMAD.WIDE.U32, whose 64-bit result
#: takes two INT32 issue slots (its low and high words); the reduction is
#: one reduce_p a sum of at most 4096 products, left out, so the bound
#: stays a lower bound
FIELD_MAC_SLOTS = 2
#: operations a field multiply-add counts (a multiply and an add)
OPS_PER_FIELD_MAC = 2
#: field operations a second: 2 ops / 2 slots at INT32_INST_PER_S
FIELD_OPS_PER_S = OPS_PER_FIELD_MAC * INT32_INST_PER_S / FIELD_MAC_SLOTS
#: dense BF16 tensor-core FLOP/s with FP32 accumulate (NVIDIA H100 Tensor
#: Core GPU Architecture whitepaper, H100 SXM5: 989.4 TFLOPS, 1978.9 with
#: sparsity): the counterpart of the JAX roofline's PEAK_FLOPS
BF16_FLOPS_PER_S = 989.4e12
#: the collective term's link, bytes a second each way a GPU: NVLink 4 on
#: an SXM card (18 links, 900 GB/s both ways), or one ConnectX-7 NDR 400
#: Gb/s InfiniBand port a GPU between hosts
LINK_BYTES_PER_S = {"nvlink4": 450e9, "ndr400": 50e9}

_WORD = 4                     # every field element is an int32


def bound(bytes_moved: float, ops: float) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    HBM_BYTES_PER_S and the field operations over FIELD_OPS_PER_S."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FIELD_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def read_elements(shape, stride) -> int:
    """Elements a kernel must read of a strided view: each element of its
    storage once, so a broadcast (stride 0) counts its storage and a view
    with gaps between its rows counts only its own elements."""
    numel = 1
    for n in shape:
        numel *= n
    if numel == 0:
        return 0
    return min(numel, 1 + sum((n - 1) * st for n, st in zip(shape, stride)))


def gemm_work(a_shape, a_stride, b_shape, b_stride) -> tuple:
    """(ops, bytes) of one field GEMM (modmatmul: 2-D operands;
    modmatmul_batched: a leading batch)."""
    if len(a_shape) == 2:
        bsz, (m, k), n = 1, a_shape, b_shape[1]
    else:
        (bsz, m, k), n = a_shape, b_shape[2]
    words = (read_elements(a_shape, a_stride)
             + read_elements(b_shape, b_stride) + bsz * m * n)
    return (OPS_PER_FIELD_MAC * bsz * m * k * n, _WORD * words)


def gradient_work(n: int, m: int, d: int, c: int, degree: int) -> tuple:
    """(ops, bytes) of one coded-gradient launch: f[i] = X~[i]^T
    ghat(X~[i] w~[i]) for n clients, X~ (m, d), a (d, c) model: two field
    multiply-adds an element of X~ a class."""
    words = n * m * d + 2 * n * d * c + degree + 1
    return (2 * OPS_PER_FIELD_MAC * n * m * d * c, _WORD * words)


def fused_work(n: int, m: int, d: int, c: int, degree: int) -> tuple:
    """(ops, bytes) of one fused_step launch: the gradient's work, and its
    epilogue's operands (decode base, X^T y, model, TruncPr [r] + bias and
    [r0] in; f and new w out; the (n,) rows)."""
    words = n * m * d + 7 * n * d * c + 3 * n + degree + 1
    return (2 * OPS_PER_FIELD_MAC * n * m * d * c, _WORD * words)


def poly_work(length: int, degree: int) -> tuple:
    """(ops, bytes) of one poly_eval launch (Horner: degree multiply-adds
    an element)."""
    return (OPS_PER_FIELD_MAC * degree * length,
            _WORD * (2 * length + degree + 1))


def copml_model_ops(n: int, m: int, d: int, k: int, t: int, r: int) -> float:
    """Useful operations of one COPML iteration (paper Table II, the JAX
    package's launch/copml_dist.py count): per client, encode the model
    d*N*(K+T), the local coded gradient 2*ceil(m/K)*d, the decode d*R*K
    field multiply-adds; all N clients; 2 operations a multiply-add."""
    mk = -(-m // k)
    macs = (d * n * (k + t) + 2 * mk * d + d * r * k) * n
    return float(OPS_PER_FIELD_MAC * macs)


@dataclasses.dataclass
class Roofline:
    name: str
    chips: int
    ops: float                   # executed (the JAX package's hlo_flops)
    bytes: float                 # executed (its hlo_bytes)
    coll_bytes_per_device: float
    model_ops: float = 0.0       # useful (its model_flops)
    link: str = "nvlink4"

    def __post_init__(self):
        if self.link not in LINK_BYTES_PER_S:
            raise ValueError(f"unknown link {self.link!r}: one of "
                             f"{sorted(LINK_BYTES_PER_S)}")

    @property
    def compute_s(self) -> float:
        return self.ops / (self.chips * FIELD_OPS_PER_S)

    @property
    def memory_s(self) -> float:
        return self.bytes / (self.chips * HBM_BYTES_PER_S)

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_device / LINK_BYTES_PER_S[self.link]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ops_ratio(self) -> float:
        return self.model_ops / self.ops if self.ops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """How close the useful work runs to the binding term:
        (model_ops / peak) / bound_s."""
        if not self.model_ops or not self.bound_s:
            return 0.0
        return self.model_ops / (self.chips * FIELD_OPS_PER_S) / self.bound_s

    def to_dict(self) -> dict:
        return {
            "name": self.name, "chips": self.chips, "link": self.link,
            "ops": self.ops, "bytes": self.bytes,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "model_ops": self.model_ops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_ops_ratio": self.useful_ops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


# --------------------------------------------------------------- LM serving

#: per-layer parameters that are not matrix-product operands
_NOT_MATMUL = ("conv_w", "a_log")


def _lm_terms(cfg) -> dict:
    """Matrix-product parameters a token multiplies, by what it is applied
    to: "layer" (every decoder layer, MoE experts at top_k / n_experts,
    the router in), "shared" (zamba2's shared block, once a group),
    "cross_kv" (whisper's cross K/V projections: encoder tokens),
    "encoder" (whisper's encoder layers) and "patch" (internvl2's patch
    projection: patch tokens), each summed over its layers; the weights'
    bytes, and of them the MoE experts' ("expert_bytes")."""
    from ..models.model import param_table
    terms = dict(layer=0.0, shared=0.0, cross_kv=0.0, encoder=0.0,
                 patch=0.0, weight_bytes=0, expert_bytes=0)
    for name, par in param_table(cfg).items():
        numel = 1
        for n in par.shape:
            numel *= n
        nbytes = numel * (4 if (par.dtype or cfg.dtype) == "float32" else 2)
        terms["weight_bytes"] += nbytes
        leaf = name.split("/")[-1]
        stacked = name.startswith(("layers/", "enc_layers/"))
        if len(par.shape) - stacked < 2 or leaf in _NOT_MATMUL \
                or name == "embed":
            continue
        if name.startswith("enc_layers/"):
            terms["encoder"] += numel
        elif leaf in ("xwk", "xwv"):
            terms["cross_kv"] += numel
        elif name.startswith("shared_attn/"):
            terms["shared"] += numel * (cfg.n_layers // cfg.attn_every)
        elif name == "patch_proj":
            terms["patch"] += numel
        elif leaf in ("w_gate", "w_up", "w_down") and cfg.family == "moe":
            terms["layer"] += numel * cfg.top_k / cfg.n_experts
            terms["expert_bytes"] += nbytes
        else:
            terms["layer"] += numel
    return terms


def _weight_bytes(cfg, t: dict, tokens: int) -> float:
    """The weights a step over `tokens` tokens must read: all but the MoE
    experts, and of each MoE layer's experts the min(n_experts, tokens x
    top_k) that its tokens can route to (a bound: the router may pick
    fewer distinct ones)."""
    if cfg.family != "moe":
        return t["weight_bytes"]
    used = min(cfg.n_experts, tokens * cfg.top_k)
    return t["weight_bytes"] - t["expert_bytes"] + \
        t["expert_bytes"] * used / cfg.n_experts


def _attn_layers(cfg) -> int:
    """Self-attention applications a forward makes."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    return cfg.n_layers


def _kv_bytes(cfg, batch: int, seq: int) -> float:
    """The self-attention K/V of `seq` positions, and whisper's cross K/V."""
    elem = 4 if cfg.dtype == "float32" else 2
    per = 2 * batch * cfg.n_kv * cfg.hd * elem
    out = _attn_layers(cfg) * per * seq
    if cfg.family == "encdec":
        out += cfg.n_layers * per * cfg.encoder_seq
    return out


def _state_bytes(cfg, batch: int) -> float:
    """A state-space layer's conv and ssm states (float32 ssm state)."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    elem = 4 if cfg.dtype == "float32" else 2
    conv = (cfg.ssm_conv - 1) * cfg.d_inner * elem
    return cfg.n_layers * batch * (conv + cfg.d_inner * cfg.ssm_state * 4)


def _forward_ops(cfg, t: dict, batch: int, s0: int, logit_rows: int):
    """Operations of one forward over (batch, s0) tokens: the products of
    every token through the layers (vlm: the patch prefix too),
    `logit_rows` positions' logits a sequence, causal self-attention
    (S(S+1)/2 pairs), whisper's encoder and cross-attention."""
    seq = s0 + (cfg.n_patches if cfg.family == "vlm" else 0)
    tokens = batch * seq
    macs = tokens * (t["layer"] + t["shared"]) + batch * logit_rows * \
        cfg.vocab * cfg.d_model
    attn = 4 * batch * cfg.n_heads * cfg.hd
    ops = 2 * macs + attn * _attn_layers(cfg) * seq * (seq + 1) / 2
    if cfg.family == "vlm":
        ops += 2 * batch * cfg.n_patches * t["patch"]
    if cfg.family == "encdec":
        se = cfg.encoder_seq
        ops += 2 * batch * se * (t["encoder"] + t["cross_kv"])
        ops += attn * (cfg.encoder_layers * se * se + cfg.n_layers * seq * se)
    return ops


def lm_prefill_work(cfg, batch: int, s0: int) -> tuple:
    """(operations, bytes) of prefill_step on (batch, s0) prompts: a
    forward (_forward_ops) with the last position's logits; every weight
    the tokens need read once and the caches written.  The state-space
    scans' elementwise operations are left out (a lower bound)."""
    t = _lm_terms(cfg)
    seq = s0 + (cfg.n_patches if cfg.family == "vlm" else 0)
    ops = _forward_ops(cfg, t, batch, s0, 1)
    nbytes = _weight_bytes(cfg, t, batch * seq) + \
        _kv_bytes(cfg, batch, seq) + _state_bytes(cfg, batch)
    return ops, nbytes


def opt_state_bytes(cfg) -> float:
    """Bytes of the config's optimizer state (float32): adamw two moments
    a parameter, sgdm one, adafactor a row and a column statistic a >= 2-D
    parameter and one moment a vector."""
    from ..models.model import param_table
    total = 0
    for par in param_table(cfg).values():
        numel = 1
        for n in par.shape:
            numel *= n
        if cfg.optimizer == "adamw":
            total += 2 * numel
        elif cfg.optimizer == "sgdm":
            total += numel
        elif len(par.shape) >= 2:
            total += numel // par.shape[-1] + numel // par.shape[-2]
        else:
            total += numel
    return 4.0 * total


def lm_train_work(cfg, batch: int, seq: int, remat: bool = True) -> tuple:
    """(operations, bytes) of one train_step on (batch, seq) tokens.

    Operations: the forward with every position's logits, three times
    (the forward, and backward's two products a forward product: the
    input's gradient and the weight's), and once more under remat (the
    layers recomputed in backward).  Bytes: the weights read and their
    gradients written (the parameters' types; all experts of an MoE
    layer, since a batch of training tokens routes to every expert), and
    the optimizer state read and written once."""
    t = _lm_terms(cfg)
    ops = _forward_ops(cfg, t, batch, seq, seq) * (4 if remat else 3)
    nbytes = 2 * t["weight_bytes"] + 2 * opt_state_bytes(cfg)
    return ops, nbytes


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS (the JAX package's launch/roofline.py): 6 N D for
    training (N active parameters for MoE); prefill 2 N a token (forward
    only); decode 2 N a token plus the K/V attention term."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    tokens = shape.global_batch
    attn = 0.0
    if cfg.n_heads:
        attn = (4.0 * cfg.n_layers * cfg.n_heads * cfg.hd * shape.seq_len
                * tokens)
    return 2.0 * n_active * tokens + attn


def lm_decode_work(cfg, batch: int, cache_len: int) -> tuple:
    """(operations, bytes) of one decode_step: one token a sequence through
    the layers and the logits, attention over the whole cache_len cache
    (and whisper's encoder_seq cross cache); every weight the batch's
    tokens need read once (MoE: min(n_experts, batch x top_k) experts a
    layer), the whole K/V cache read, the state-space states read and
    written."""
    t = _lm_terms(cfg)
    macs = batch * (t["layer"] + t["shared"]) + batch * cfg.vocab * \
        cfg.d_model
    attn = 4 * batch * cfg.n_heads * cfg.hd
    ops = 2 * macs + attn * _attn_layers(cfg) * cache_len
    if cfg.family == "encdec":
        ops += attn * cfg.n_layers * cfg.encoder_seq
    nbytes = _weight_bytes(cfg, t, batch) + _kv_bytes(cfg, batch, cache_len) \
        + 2 * _state_bytes(cfg, batch)
    return ops, nbytes


def lm_bound(ops: float, bytes_moved: float) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    HBM_BYTES_PER_S and the operations over BF16_FLOPS_PER_S."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
