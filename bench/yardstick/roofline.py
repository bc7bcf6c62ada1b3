"""The yardstick's peaks and work counts for one NVIDIA H100 SXM5 card.

A copy, kept with the benchmark so that a change to the program cannot move
it, of the arithmetic in the port's `launch/roofline.py`:

  HBM_BYTES_PER_S   3.35e12 B/s, NVIDIA's H100 SXM5 data sheet.
  FIELD_OPS_PER_S   16.73e12 field operations a second.  Not a published
                    number: 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
                    (the H100 architecture whitepaper's SM count and INT32
                    units), a field multiply-add priced at two operations
                    and two INT32 issue slots (its 64-bit product).

A bound is the larger of bytes over bandwidth and operations over the field
peak; every input is read once, every output written once, and 2
operations a field multiply-add.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS = 132
INT32_LANES_PER_SM = 64
BOOST_CLOCK_HZ = 1.98e9
FIELD_OPS_PER_S = SMS * INT32_LANES_PER_SM * BOOST_CLOCK_HZ
OPS_PER_FIELD_MAC = 2
WORD = 4                      # a field element is an int32


def bound_s(ops: float, nbytes: float) -> tuple:
    """(least seconds, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FIELD_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gemm_work(m: int, k: int, n: int) -> tuple:
    """(ops, bytes) of a dense field GEMM (m, k) @ (k, n)."""
    return (OPS_PER_FIELD_MAC * m * k * n, WORD * (m * k + k * n + m * n))


def fused_work(n: int, mk: int, d: int, c: int, degree: int) -> tuple:
    """(ops, bytes) of one fused COPML step: every client's coded gradient
    X~_i^T ghat(X~_i w~_i) (two multiply-adds an element of X~ a class)
    and its epilogue's operands (decode base, X^T y, model, TruncPr's two
    draws in; gradients and the new model out; three (n,) rows)."""
    words = n * mk * d + 7 * n * d * c + 3 * n + degree + 1
    return (2 * OPS_PER_FIELD_MAC * n * mk * d * c, WORD * words)


def copml_model_ops(n: int, m: int, d: int, k: int, t: int, r: int) -> float:
    """Useful operations of one COPML iteration (paper Table II): per
    client the model encode d*N*(K+T), the local coded gradient
    2*ceil(m/K)*d and the decode d*R*K multiply-adds; all N clients."""
    mk = -(-m // k)
    macs = (d * n * (k + t) + 2 * mk * d + d * r * k) * n
    return float(OPS_PER_FIELD_MAC * macs)


def copml_step_bytes(n: int, m: int, d: int, k: int) -> float:
    """Least bytes of one iteration: the coded rows X~ read once, the model
    shares and X^T y shares read once, the new model shares written once."""
    mk = -(-m // k)
    return float(WORD * (n * mk * d + 3 * n * d))


def serve_window_work(b: int, d: int, n: int, t: int, cols: int) -> tuple:
    """(ops, bytes) of one scoring window: B float32 queries read, the
    (d, N*C') model shares read, the packed score GEMM, the open of B*C'
    logits from T+1 shares, B*C' logits written."""
    ops = OPS_PER_FIELD_MAC * (b * d * n * cols + (t + 1) * b * cols)
    nbytes = WORD * (b * d + d * n * cols + b * cols)
    return float(ops), float(nbytes)
