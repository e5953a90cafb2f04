"""Public kernel entry points of the paged attention path.

Model code calls these, never a kernel wrapper directly. Dispatch is by
the tensor's device alone: a CPU tensor runs the plain PyTorch version, a
CUDA tensor launches the Hopper kernel (or raises). There is no override
and no environment switch.

    prefill_attention(...) gather-free paged prefill (paged flash | plain)
    decode_attention(...)  paged decode attention (paged kernel | plain),
                           optionally with the KV write fused in
"""
from __future__ import annotations

from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_fused)
from repro_torch.kernels.paged_flash_attention import paged_flash_attention


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
