"""Gather-free chunked-prefill flash attention on Hopper.

Replaces the Pallas TPU kernel ``paged_flash_attention``
(``src/repro/kernels/paged_flash_attention.py:101``, body ``_kernel``);
the CUDA source is ``csrc/paged_flash_attention.cu``. Queries
``(B, Hq, Sq, D)`` attend over pool pages ``(P, page, Hkv, D)`` that the
block table steers; every page is read in place, with no dense
``pages[table]`` gather (avoiding that O(context) copy per chunk is the
point of the kernel). Mask: ``kv_pos <= q_offset + i`` and
``kv_pos < kv_len``, so scratch pages and stale tails never contribute.

What bounds it on the H100: a chunk of C queries over a context of N
tokens does about ``4 * C * N * Hq * D`` flops against about
``4 * N * Hkv * D * itemsize`` bytes of KV, so at main-path chunk sizes it
is compute-bound, and the tensor cores are the resource. The kernel has
two paths, chosen by dtype:

- **bfloat16** (the serving path) runs the tensor-core core shared with
  the dense kernel (``csrc/attn_mma.cuh``), its key rows addressed through
  the block table (any page size; a 64-key tile may span pages), copied
  with ``cp.async`` into a 2-stage ring, ``mma.sync`` products, one
  online-softmax rescale per tile. Keys past what any row may see are
  zero-filled, never read. q and the pools must start 16-byte aligned.
- **float32** (the parity sweeps and the f32 model phases) keeps the
  CUDA-core body, which stages one page of K and V in shared memory as
  f32: ``2 * page * D * 4`` bytes, at most 48 KiB (checked, for f32 only).

Both stop at the last key any of their rows can see and mask ragged Sq
rows themselves. PERF.md records the times against the bound.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.paged_flash_attention_ref`); on a CUDA
tensor it launches the kernel or raises. ``.launches`` counts launches.
Block-table indices are trusted; shapes, dtypes, devices and contiguity
are checked. The kernel has no gradient (no training path runs it): on
the card, an input that requires grad under grad mode raises
(``_grad.refuse_grad``) rather than come back detached.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _grad
from repro_torch.kernels.ref import paged_flash_attention_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_SMEM_LIMIT = 48 * 1024            # the f32 path's staged page
_vp, _int = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_flash_attention")
    fn = lib.paged_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [_int, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _int, _int,
                       _int, _int, _int, _int, _int, ctypes.c_float, _vp]
        fn.restype = ctypes.c_int
        lib.paged_flash_rows_per_block.argtypes = []
        lib.paged_flash_rows_per_block.restype = ctypes.c_int
    return lib


def _check(q, k_pages, v_pages, block_table, kv_len, q_offset):
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError("q must be (B, Hq, Sq, D), pages (P, page, Hkv, D)")
    B, Hq, Sq, D = q.shape
    P, page, Hkv, Dk = k_pages.shape
    if Dk != D or v_pages.shape != k_pages.shape or Hq % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_HEAD_DIMS}")
    if q.dtype == torch.float32 and 2 * page * D * 4 > _SMEM_LIMIT:
        raise ValueError(f"f32 page={page}, D={D} needs more than 48 KiB of "
                         "shared memory")
    if block_table.dim() != 2 or block_table.shape[0] != B or \
            tuple(kv_len.shape) != (B,) or tuple(q_offset.shape) != (B,):
        raise ValueError("block_table must be (B, Np), kv_len/q_offset (B,)")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {q.dtype}")
    for t in (q, k_pages, v_pages, block_table, kv_len, q_offset):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("paged flash attention needs contiguous tensors")
    for t in (block_table, kv_len, q_offset):
        if t.dtype != torch.int32:
            raise TypeError("block table, kv_len and q_offset must be int32")
    for t in (k_pages, v_pages):
        if t.dtype != q.dtype:
            raise TypeError(f"pool dtype {t.dtype} != q {q.dtype}")
    if q.dtype == torch.bfloat16:    # the tensor-core path's cp.async rows
        for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
            if t.data_ptr() % 16:
                raise ValueError(f"bf16 {name} must start on a 16-byte "
                                 "boundary")


def paged_flash_attention(q, k_pages, v_pages, block_table, kv_len,
                          q_offset):
    """q: (B, Hq, Sq, D); k/v_pages: (P, page, Hkv, D); block_table: (B, Np)
    int32 pool page ids in token order (scratch-padded); kv_len: (B,) int32
    valid kv tokens (the chunk's own KV already scattered into its pages);
    q_offset: (B,) int32 absolute position of each row's first query.
    Returns (B, Hq, Sq, D). ``Sq`` may be ragged; ``kv_len``/``q_offset``
    stay on the device (no host round trip per chunk)."""
    if q.device.type == "cpu":
        return paged_flash_attention_ref(q, k_pages, v_pages, block_table,
                                         kv_len, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_attention: no kernel for {q.device}")
    _grad.refuse_grad("paged_flash_attention", q, k_pages, v_pages)
    _check(q, k_pages, v_pages, block_table, kv_len, q_offset)
    B, Hq, Sq, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    G = Hq // Hkv
    o = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return o
    lib = _lib()
    if G > lib.paged_flash_rows_per_block():
        raise ValueError(f"{G} query heads per kv head exceed one block")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_flash_attention(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_table.data_ptr(), kv_len.data_ptr(),
            q_offset.data_ptr(), o.data_ptr(), B, Sq, block_table.shape[1],
            page, Hkv, G, D, D ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"paged_flash_attention launch failed: CUDA error "
                           f"{rc}")
    paged_flash_attention.launches += 1
    return o


paged_flash_attention.launches = 0
