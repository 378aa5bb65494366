"""The work of each port kernel, from a call's shapes: one count for the
smoke's bounds, the dry run's walk and any roofline over them.

Each function gives a ``Work``: the operations the function itself does
(not a kernel's own, larger, recomputing count), the bytes it must move
(each input read once, each output written once) and the type whose
peak rate its operations run at. The counts are the expressions each
``chip_smoke.py`` check has used for its bound since its kernel was
ported:

- B1 reads the live positions' K and V and q, writes out; four products a
  live position and query head over hd (scores and values);
- B2 reads q, k, v and writes out (and lse in training); two products a
  pair of the causal (+SWA) band over hd and hd_v: 2 * (hd + hd_v) a pair;
- B2-bwd reads q, k, v, out, dout and lse, writes dq, dk, dv; five
  products a pair (scores and dq, dk over hd; dp and dv over hd_v): 6 * hd
  + 4 * hd_v a pair;
- B3, B4 and B4-bwd read r, k, v in their type and everything else in
  fp32; fp32 operations (B3 7 hd^2 a head, B4 the strictly-lower scores
  with v and the carried state, B4-bwd ~10 hd^2 a token and head);
- B5, B6 and B6-bwd are fp32 elementwise recurrences;
- B7 and B7-bwd move rows and do no arithmetic.

Where the work depends on the data (B1's live positions, B7's kept
rows), the caller passes this run's count; without it the function counts
the most the shapes allow, which is what a wrapper reports, since it never
reads its inputs back to the host.

``bound_s`` prices a ``Work`` on the NVIDIA H100 80GB HBM3 (SXM) at its
700 W limit, from NVIDIA's data sheet, dense: 3.35e12 B/s of device
memory, 989e12 operations/s in bf16 on the tensor cores, 67e12 in fp32.

The wrappers report each call's work to every active ``observe`` hook
(the cost walk, ``launch/cost_walk.py``), on ``cuda`` and ``meta`` alike.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

CARD = "NVIDIA H100 80GB HBM3 (SXM), 700 W"
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
_ESIZE = {"bfloat16": 2, "float32": 4}


@dataclass(frozen=True)
class Work:
    flops: float
    nbytes: float
    dtype: str          # the type whose peak rate prices the operations


def bound_s(work: Work) -> float:
    """The least seconds the card could take: the larger of the bytes
    over the memory rate and the operations over the type's peak."""
    return max(work.nbytes / HBM_BYTES_PER_S,
               work.flops / PEAK_FLOPS[work.dtype])


def bound_by(work: Work) -> str:
    """Which term ``bound_s`` took: ``bytes`` (ties too) or
    ``operations``."""
    t_ops = work.flops / PEAK_FLOPS[work.dtype]
    return "bytes" if work.nbytes / HBM_BYTES_PER_S >= t_ops else "operations"


def band_pairs(S: int, window: int = 0) -> int:
    """(query, key) pairs of the causal band, narrowed to ``window`` keys
    where one is set."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def paged_decode_attention(B: int, H: int, KV: int, hd: int, MP: int,
                           page: int, dtype: str,
                           live: Optional[int] = None) -> Work:
    """B1: ``live`` positions summed over the slots (min(length, MP *
    page) each; all B * MP * page if not given)."""
    live = B * MP * page if live is None else live
    return Work(4.0 * H * hd * live,
                _ESIZE[dtype] * (2 * live * KV * hd + 2 * B * H * hd)
                + 4 * (B * MP + B), dtype)


def flash_attention(B: int, H: int, KV: int, S: int, hd: int, hd_v: int,
                    window: int, dtype: str, lse: bool = False) -> Work:
    """B2 over the band's pairs; ``lse`` also writes [B,H,S] fp32."""
    pairs = band_pairs(S, window)
    nbytes = _ESIZE[dtype] * (B * H * S * (hd + hd_v) + B * KV * S
                              * (hd + hd_v))
    return Work(2.0 * (hd + hd_v) * B * H * pairs,
                nbytes + (4 * B * H * S if lse else 0), dtype)


def flash_attention_bwd(B: int, H: int, KV: int, S: int, hd: int,
                        hd_v: int, window: int, dtype: str) -> Work:
    """B2-bwd: q, k, v, out, dout, lse read; dq, dk, dv written."""
    pairs = band_pairs(S, window)
    return Work((6.0 * hd + 4.0 * hd_v) * B * H * pairs,
                _ESIZE[dtype] * 2 * (B * H * S * (hd + hd_v)
                                     + B * KV * S * (hd + hd_v))
                + 4 * B * H * S, dtype)


def wkv6_chunked(B: int, S: int, H: int, hd: int, chunk: int,
                 rkv_dtype: str) -> Work:
    """B4 in chunks of min(chunk, S) (c valid tokens each): the strictly
    lower scores and their product with v, 2 c (c - 1) hd; the carried
    state read and updated, 4 c hd^2."""
    C = min(chunk, S)
    cs = [C] * (S // C) + ([S % C] if S % C else [])
    flops = B * H * sum(2 * c * (c - 1) * hd + 4 * c * hd * hd for c in cs)
    return Work(flops, B * S * H * hd * (3 * _ESIZE[rkv_dtype] + 4 + 4)
                + 4 * H * hd + 2 * 4 * B * H * hd * hd, "float32")


def wkv6_chunked_bwd(B: int, S: int, H: int, hd: int,
                     rkv_dtype: str) -> Work:
    """B4-bwd: r, k, v, logw, dy read and their gradients written; u,
    state0 and the final state's gradient read, du and dstate0 written;
    ~10 hd^2 a token and head."""
    return Work(10.0 * hd * hd * B * H * S,
                B * S * H * hd * (6 * _ESIZE[rkv_dtype] + 12) + 8 * H * hd
                + 12 * B * H * hd * hd, "float32")


def wkv6_decode(B: int, H: int, hd: int, rkv_dtype: str) -> Work:
    """B3: r, k, v, w, u and the state read, y and the new state
    written."""
    return Work(7.0 * B * H * hd * hd,
                B * H * hd * (3 * _ESIZE[rkv_dtype] + 4 + 4) + 4 * H * hd
                + 2 * 4 * B * H * hd * hd, "float32")


def ssm_decode_step(B: int, Di: int, N: int) -> Work:
    """B5: h and dA read, h' written, dtx, B and C read, y written; two
    multiplies and an add for h', a multiply and an add for y."""
    n = B * Di * N
    return Work(5.0 * n, 4 * (3 * n + 2 * B * Di + 2 * B * N), "float32")


def linear_scan(B: int, T: int, D: int, N: int) -> Work:
    """B6: a, b read, every h_t written, h0 read, h_last written; a
    multiply and an add an element and step."""
    n = B * T * D * N
    return Work(2.0 * n, 4 * (3 * n + 2 * B * D * N), "float32")


def linear_scan_bwd(B: int, T: int, D: int, N: int) -> Work:
    """B6-bwd: a, h_all and its gradient read, da and db written; h0 and
    g_last read, dh0 written; an add and two multiplies an element and
    step."""
    n = B * T * D * N
    return Work(3.0 * n, 4 * (5 * n + 3 * B * D * N), "float32")


def moe_dispatch(T: int, D: int, E: int, C: int, dtype: str,
                 kept: Optional[int] = None) -> Work:
    """B7: the kept rows read, ids and positions read, the whole [E,C,D]
    buffer written (min(T, E * C) rows kept if not given)."""
    kept = min(T, E * C) if kept is None else kept
    return Work(0.0, _ESIZE[dtype] * D * (kept + E * C) + 8 * T, dtype)


def moe_dispatch_bwd(T: int, D: int, E: int, C: int, dtype: str,
                     kept: Optional[int] = None) -> Work:
    """B7-bwd: each kept row's slot read, ids and positions read, every
    row of the gradient written."""
    kept = min(T, E * C) if kept is None else kept
    return Work(0.0, _ESIZE[dtype] * D * (kept + T) + 8 * T, dtype)


# --------------------------------------------------------------------------
# the wrappers' reports
# --------------------------------------------------------------------------

_observers: List[Callable[[str, Work], None]] = []


def observe(fn: Callable[[str, Work], None]) -> None:
    """Call ``fn(name, work)`` on every wrapper call from now on, until
    ``unobserve(fn)``."""
    _observers.append(fn)


def unobserve(fn: Callable[[str, Work], None]) -> None:
    _observers.remove(fn)


def report(name: str, work: Work) -> None:
    """A wrapper's call on ``cuda`` or ``meta``: its work, to every
    observer."""
    for fn in list(_observers):
        fn(name, work)


def dtype_name(t) -> str:
    """``bfloat16`` or ``float32`` of a tensor."""
    return str(t.dtype).split(".")[-1]
