"""Public kernel entry points of the attention paths and the WKV6 time mix.

Model code calls these, never a kernel wrapper directly. Dispatch is by
the tensor's device alone: a CPU tensor runs the plain PyTorch version, a
CUDA tensor launches the Hopper kernel (or raises). There is no override
and no environment switch.

    attention(...)         dense chunked-prefill attention (flash | plain)
    prefill_attention(...) gather-free paged prefill (paged flash | plain)
    decode_attention(...)  paged decode attention (paged kernel | plain),
                           optionally with the KV write fused in
    mla_prefill_attention(...), mla_decode_attention(...)
                           absorbed MLA over a latent page pool
                           (paged_mla kernels | plain)
    wkv(...)               the RWKV6 recurrence (wkv6 kernel | plain)
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_fused)
from repro_torch.kernels.paged_flash_attention import paged_flash_attention
from repro_torch.kernels.paged_mla import paged_mla_decode, paged_mla_prefill
from repro_torch.kernels.wkv6 import wkv6


# dense chunked-prefill attention, one host ``q_offset`` for the batch:
# the wrapper itself dispatches by device (flash kernel | plain version)
attention = flash_attention

# the RWKV6 recurrence, ``wkv(r, k, v, w, u, state, *, chunk=32)``: the
# wrapper dispatches by device (wkv6 kernel | plain version); JAX's
# ``ops.wkv`` takes its ``use_kernel`` override, which the port drops
wkv = wkv6


def prefill_attention(q, k_pages, v_pages, block_table, kv_len, q_offset):
    """Gather-free chunked-prefill attention over paged KV.

    q: (B, Hq, Sq, D); pages: (P, page, Hkv, D); block_table: (B, Np);
    kv_len/q_offset: (B,) int32. The chunk's own KV must already be
    scattered into its pages. The kernel reads pages in place; the plain
    version gathers (it is the ground truth and the CPU path).
    """
    return paged_flash_attention(q, k_pages, v_pages, block_table, kv_len,
                                 q_offset)


def decode_attention(q, k_pages, v_pages, block_table, lengths, *,
                     k_new=None, v_new=None, write_pages=None,
                     write_offsets=None):
    """q: (B, Hq, D); pages: (P, page, Hkv, D); table: (B, max_pages).

    With ``k_new/v_new/write_pages/write_offsets`` the decode-side KV write
    is fused: the new token's KV (``(B, Hkv, D)``, slot contract: position
    ``lengths - 1``) lands in the pool, in place, inside the call (on the
    CPU: scatter, then attend) and the result is ``(o, k_pages, v_pages)``.
    Without them: read-only attention, returns ``o``.
    """
    if k_new is not None:
        return paged_attention_fused(q, k_pages, v_pages, block_table,
                                     lengths, k_new, v_new, write_pages,
                                     write_offsets)
    return paged_attention(q, k_pages, v_pages, block_table, lengths)


def mla_prefill_attention(q, latent_pages, block_table, kv_len, q_offset, *,
                          scale: float, rank: int):
    """Absorbed MLA chunked prefill over a latent page pool, read in place.

    q: (B, Sq, H, R + Dr) ``[q_nope W_uk^T | q_pe]``; latent_pages: (P,
    page, R + Dr), the chunk's own rows already written; block_table: (B,
    Np); kv_len/q_offset: (B,) int32. Returns (B, Sq, H, R): the softmax-
    weighted sums of the rows' first ``rank`` values.
    """
    return paged_mla_prefill(q, latent_pages, block_table, kv_len, q_offset,
                             scale=scale, rank=rank)


def mla_decode_attention(q, latent_pages, block_table, lengths, latent_new,
                         write_pages, write_offsets, *, scale: float,
                         rank: int):
    """Absorbed MLA decode over a latent page pool with the new rows'
    write fused in: q (B, H, R + Dr); latent_new (B, R + Dr) lands at
    ``write_pages``/``write_offsets`` (B,) in place (slot contract:
    position ``lengths - 1``; on the CPU: write, then attend). Returns
    (B, H, R).
    """
    return paged_mla_decode(q, latent_pages, block_table, lengths,
                            latent_new, write_pages, write_offsets,
                            scale=scale, rank=rank)
