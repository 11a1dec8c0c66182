"""top_k — the k largest (or smallest) keys with their original indices;
port of radx_tpu/ops/topk.py.

Selection as chunk sort + candidate truncation:

  1. every chunk of ``topk_chunk_elems`` rows of (key', index) sorts
     ascending on its own (``bitonic.sort_chunks_ascending``, the
     lexicographic mode: one pass, no cross-chunk merge);
  2. each chunk keeps its best k rows.  Any global top-k row is inside its
     own chunk's top k (a row dropped here has k better rows in its own
     chunk alone), so the candidates hold the exact answer;
  3. one (key', index) sort of the candidates, padded to a power of two.

Where k > topk_chunk_elems // 2, or the input is at most two chunks, the
selection cannot win and step 3 sorts everything (the JAX ``select`` rule).
Ties resolve by the smallest original index: the exact (value, index) order
of ``jax.lax.top_k``.  Keys are uint32 / int32 / float32 through the
order-preserving encodings (float total order -inf < ... < -0.0 < +0.0 <
... < +inf < nan, so with largest=True NaNs rank first).
"""

from __future__ import annotations

import torch

from radx_tpu_torch.config import DEFAULT, SortConfig
from radx_tpu_torch.kernels import bitonic
from radx_tpu_torch.ops import sort as sort_ops


def select_applies(k: int, cfg: SortConfig) -> bool:
    """The candidate pass pays one extra read and write of the input; it
    wins when the per-chunk truncation discards most rows."""
    return k <= cfg.topk_chunk_elems // 2


def _top_k(work: torch.Tensor, cfg: SortConfig, n: int, k: int,
           select: bool):
    """``work``: uint32 keys encoded so that ascending order is the wanted
    order.  Returns (the k first work keys, their int32 indices)."""
    c = cfg.topk_chunk_elems
    total = sort_ops._pad_len(n)
    kp = sort_ops._key_plane(work, total)  # pads sort after every row
    ip = sort_ops._iota(total, work.device)  # pad indices >= n lose ties
    if select and total > 2 * c:
        bitonic.sort_chunks_ascending(kp, c, lex=[ip])
        cand = [p.view(total // c, c)[:, :k].reshape(-1) for p in (kp, ip)]
        m = cand[0].numel()
        size = 1 << (m - 1).bit_length()
        kp = torch.full((size,), sort_ops._PAD_KEY, dtype=torch.int32,
                        device=work.device)
        ip = torch.full((size,), total, dtype=torch.int32, device=work.device)
        kp[:m], ip[:m] = cand
    sort_ops._lex_sort([kp, ip], cfg)
    return sort_ops._unbias(kp, k), ip[:k]


def top_k(keys, k: int, largest: bool = True, cfg: SortConfig | None = None,
          *, device=None):
    """The k largest (default) or smallest keys, with original indices.

    Returns (values, indices): values in descending order when largest
    (ascending otherwise), ties with the smallest original index first.
    ``keys``: 1-D uint32 / int32 / float32; requires 1 <= k <= len(keys)."""
    cfg = cfg or DEFAULT
    keys = sort_ops._as_tensor(keys, device)
    if keys.dtype not in sort_ops._KEY_DTYPES:
        raise TypeError(f"unsupported key dtype {keys.dtype}")
    if keys.dim() != 1:
        raise ValueError("keys must be 1-D")
    n = keys.numel()
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= {n}, got k={k}")
    enc = sort_ops._encode_keys(keys)
    work = sort_ops._flip(enc) if largest else enc
    wk, idx = _top_k(work, cfg, n, k, select_applies(k, cfg))
    if largest:
        wk = sort_ops._flip(wk)
    return sort_ops._decode_keys(wk, keys.dtype), idx
