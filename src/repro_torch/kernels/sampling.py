"""On-device token sampling: temperature -> top-k -> top-p -> draw.

The port's counterpart of ``repro.kernels.sampling``, in plain PyTorch on
the caller's device, as the reference is plain jnp (no Pallas kernel
backs it). Every row of a call depends only on its own logits, its own
parameters and its own key, so a request's stream does not depend on
its batch neighbours.

Filter semantics (per row, all parameters per-row tensors):

  1. temperature: ``logits / max(t, 1e-6)``; ``t <= 0`` returns the row's
     ``argmax`` of the raw logits (exact greedy).
  2. top-k: keep the ``k`` largest entries (``k <= 0`` or ``k >= V``
     keeps all).
  3. top-p: over the top-k-renormalised distribution, keep the sorted
     entries whose preceding mass is below ``p`` (``p >= 1`` keeps all;
     the best entry is always kept).
  4. draw: the Gumbel-max draw of ``jax.random.categorical`` over the
     masked logits in vocab order, with the row's key.

Keys and random bits are JAX's, bit for bit: threefry2x32 with
``PRNGKey(seed)`` -> ``fold_in(req_id)`` -> ``fold_in(index)``
(``derive_keys``), and the partitionable bit stream of
``jax.random.bits`` (the word of element j is the XOR of the two output
words of threefry2x32(key, (hi(j), lo(j)))). The 32-bit words ride in
int64 lanes masked to 32 bits: add, shift and xor then mean the same on
every device and every PyTorch version. The Gumbel noise (float64 logs
rounded to float32) and the top-p prefix sum (the device's ``exp`` and
``cumsum``) agree with XLA's to a few ulp, so a draw equals the
reference's wherever it is not within that noise of a tie.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float32's smallest normal number, the floor of `_uniform`
_TINY = torch.finfo(torch.float32).tiny


def _u32(x) -> torch.Tensor:
    """int32 (or any integer) tensor -> its 32-bit two's-complement word
    as a non-negative int64 (the reference's wrap to uint32)."""
    return x.to(torch.int64) & _M32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of JAX's ``threefry2x32_p`` on int64 lanes
    holding 32-bit words: keys ``(k0, k1)`` and counts ``(x0, x1)``
    broadcast together; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _fold_in(k0, k1, data):
    """``jax.random.fold_in``: threefry2x32(key, (0, data))."""
    return threefry2x32(k0, k1, torch.zeros_like(data), data)


def derive_keys(seeds, req_ids, indices):
    """Per-row keys from ``(seed, req_id, token_index)``.

    seeds/req_ids/indices: [B] integer tensors (int32 words; wider
    values wrap modulo 2^32). Returns [B, 2] int64 holding the key's two
    uint32 words: ``PRNGKey(seed)`` is ``(0, seed)`` for an int32 seed,
    then ``fold_in(req_id)``, then ``fold_in(index)``."""
    seeds, req_ids, indices = _u32(seeds), _u32(req_ids), _u32(indices)
    k0, k1 = _fold_in(torch.zeros_like(seeds), seeds, req_ids)
    k0, k1 = _fold_in(k0, k1, indices)
    return torch.stack([k0, k1], dim=-1)


def random_bits(keys, n: int):
    """``jax.random.bits(key, (n,), uint32)`` for each row's key: [B, n]
    int64 words. With the partitionable threefry the count of element j
    is (j >> 32, j & 0xFFFFFFFF); n < 2^32 here, so the high word is 0."""
    j = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    b0, b1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(j), j)
    return b0 ^ b1


def uniform(keys, n: int):
    """``jax.random.uniform(key, (n,), minval=tiny, maxval=1.)`` per row:
    the top 23 bits as a float in [1, 2), minus 1, floored at tiny."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats + _TINY, _TINY)


def gumbel(keys, n: int):
    """``jax.random.gumbel(key, (n,), float32)`` in its "low" mode,
    ``-log(-log(u))``, each log taken in float64 and rounded to float32:
    the correctly rounded float32 op, which XLA's meets to an ulp, and
    the same on every device (the CPU's float32 ``log`` has been seen 4e-5
    off on a process's first call)."""
    inner = torch.log(uniform(keys, n).double()).float()
    return (-torch.log(-inner.double())).float()


def masked_logits(logits, temperature, top_k, top_p):
    """The scaled logits with every entry the filters drop set to -inf,
    in vocab order: [B, V] float32. With ``k >= V`` (or ``k <= 0``) and
    ``p >= 1`` the result is the scaled logits exactly."""
    V = logits.shape[1]
    lg = logits.float()
    t = torch.clamp_min(temperature.float(), 1e-6)[:, None]
    scaled = lg / t
    # one stable descending sort serves both filters (ties keep vocab
    # order, as the reference's argsort of the negated logits)
    sorted_, order = torch.sort(scaled, dim=-1, descending=True, stable=True)
    pos = torch.arange(V, device=lg.device)[None, :]
    k = torch.where((top_k <= 0) | (top_k >= V), V, top_k)[:, None]
    keep_k = pos < k
    probs = torch.softmax(sorted_.masked_fill(~keep_k, float("-inf")),
                          dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    p = top_p.float()[:, None]
    keep = keep_k & (((cum - probs) < p) | (p >= 1.0))
    keep[:, 0] = True
    keep_vocab = torch.zeros_like(keep).scatter_(1, order, keep)
    return scaled.masked_fill(~keep_vocab, float("-inf"))


def sample_logits(logits, keys, temperature, top_k, top_p):
    """Fused temperature -> top-k -> top-p -> categorical draw.

    logits: [B, V]; keys: [B, 2] (``derive_keys``); temperature/top_p:
    [B] float; top_k: [B] int. Returns [B] int32; rows with
    ``temperature <= 0`` return ``argmax`` of the raw logits."""
    greedy = torch.argmax(logits.float(), dim=-1).to(torch.int32)
    masked = masked_logits(logits, temperature, top_k, top_p)
    drawn = torch.argmax(gumbel(keys, masked.shape[1]) + masked,
                         dim=-1).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, drawn)


def token_logprob(logits, tokens):
    """Log-probability of each chosen token under the raw logits: [B]
    float32 (the pre-filter log-softmax, whatever picked the token)."""
    lsm = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lsm, 1, tokens.long()[:, None])[:, 0]
