"""Paged decode attention on Hopper: ``paged_attention_fused`` and the
read-only ``paged_attention``.

Replaces the Pallas TPU kernels ``paged_attention_fused``
(``src/repro/kernels/paged_attention.py:143``, body ``_fused_kernel``) and
``paged_attention`` (``:217``, body ``_kernel``). Both launch one CUDA
source, ``csrc/paged_attention.cu``, templated on ``FUSED`` and the
element type (float32, bfloat16).

What bounds it on the H100: decode reads every valid KV byte of the batch
once (``2 * sum(lengths) * Hkv * D * itemsize``) and does about ``4 * G * D``
flops per KV token, far below the ~295 flops per byte where the tensor
cores become the limit, so the memory rate sets the bound. The simple
design (one block per (lane, kv head), pages staged through shared memory
as f32, no async copies) reads each byte once but runs few blocks at small
batch; PERF.md records its time against that bound.

On a CPU tensor the wrappers run the plain versions in
:mod:`repro_torch.kernels.ref`; on a CUDA tensor they launch the kernel or
raise. Each wrapper counts its kernel launches in ``.launches``.
Block-table and slot indices are trusted (they come from the engine's
binding map); shapes, dtypes, devices and contiguity are checked.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 48 * 1024
_vp, _int = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [_int, _int, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                       _vp, _vp, _int, _int, _int, _int, _int, _int,
                       ctypes.c_float, _vp]
        fn.restype = ctypes.c_int
        lib.paged_decode_smem_bytes.argtypes = [_int, _int, _int]
        lib.paged_decode_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check(q, k_pages, v_pages, block_table, lengths, k_new=None,
           v_new=None, write_pages=None, write_offsets=None):
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("q must be (B, Hq, D) and pages (P, page, Hkv, D)")
    B, Hq, D = q.shape
    P, page, Hkv, Dk = k_pages.shape
    if Dk != D or v_pages.shape != k_pages.shape or Hq % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B or \
            tuple(lengths.shape) != (B,):
        raise ValueError("block_table must be (B, max_pages), lengths (B,)")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {q.dtype}")
    tensors = [q, k_pages, v_pages, block_table, lengths]
    if k_new is not None:
        if tuple(k_new.shape) != (B, Hkv, D) or v_new.shape != k_new.shape:
            raise ValueError("k_new/v_new must be (B, Hkv, D)")
        if tuple(write_pages.shape) != (B,) or \
                tuple(write_offsets.shape) != (B,):
            raise ValueError("write_pages/write_offsets must be (B,)")
        tensors += [k_new, v_new, write_pages, write_offsets]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("paged attention needs contiguous tensors")
    for t in tensors[3:5] + tensors[7:]:
        if t.dtype != torch.int32:
            raise TypeError("block table, lengths and slots must be int32")
    for t in (k_pages, v_pages) + tuple(tensors[5:7]):
        if t.dtype != q.dtype:
            raise TypeError(f"pool/new KV dtype {t.dtype} != q {q.dtype}")


def _launch(fused, q, k_pages, v_pages, block_table, lengths, k_new, v_new,
            write_pages, write_offsets):
    B, Hq, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    G = Hq // Hkv
    o = torch.empty_like(q)
    lib = _lib()
    if lib.paged_decode_smem_bytes(G, page, D) > _SMEM_LIMIT:
        raise ValueError(f"G={G}, page={page}, D={D} needs more than 48 KiB "
                         "of shared memory")
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_decode_attention(
            _DTYPE_CODE[q.dtype], int(fused), q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), block_table.data_ptr(),
            lengths.data_ptr(), ptr(k_new), ptr(v_new), ptr(write_pages),
            ptr(write_offsets), o.data_ptr(), B, block_table.shape[1], page,
            Hkv, G, D, D ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {rc}")
    return o


def paged_attention_fused(q, k_pages, v_pages, block_table, lengths, k_new,
                          v_new, write_pages, write_offsets):
    """Decode attention with the KV write fused into the kernel.

    q: (B, Hq, D); k/v_pages: (P, page, Hkv, D); block_table: (B, max_pages)
    int32; lengths: (B,) int32 valid kv tokens INCLUDING the new token;
    k/v_new: (B, Hkv, D) the new token's KV; write_pages/write_offsets: (B,)
    int32, its pool slot. Contract: the slot is the table position of
    sequence index ``lengths[b] - 1``; idle lanes have length 1, an
    all-scratch table row and the slot (scratch, 0).

    Returns ``(o (B, Hq, D), k_pages, v_pages)``: the pools are the input
    tensors, updated IN PLACE (the JAX kernel donated them to aliased
    outputs instead).
    """
    if q.device.type == "cpu":
        k_pages.index_put_((write_pages.long(), write_offsets.long()), k_new)
        v_pages.index_put_((write_pages.long(), write_offsets.long()), v_new)
        o = paged_attention_ref(q, k_pages, v_pages, block_table, lengths)
        return o, k_pages, v_pages
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_fused: no kernel for {q.device}")
    _check(q, k_pages, v_pages, block_table, lengths, k_new, v_new,
           write_pages, write_offsets)
    if q.shape[0] == 0:
        return torch.empty_like(q), k_pages, v_pages
    o = _launch(True, q, k_pages, v_pages, block_table, lengths, k_new,
                v_new, write_pages, write_offsets)
    paged_attention_fused.launches += 1
    return o, k_pages, v_pages


paged_attention_fused.launches = 0


def paged_attention(q, k_pages, v_pages, block_table, lengths):
    """Read-only paged decode attention: q (B, Hq, D); k/v_pages
    (P, page, Hkv, D); block_table (B, max_pages) int32; lengths (B,) int32
    -> (B, Hq, D). Mask: ``kv_pos < lengths[b]``."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    _check(q, k_pages, v_pages, block_table, lengths)
    if q.shape[0] == 0:
        return torch.empty_like(q)
    o = _launch(False, q, k_pages, v_pages, block_table, lengths, None, None,
                None, None)
    paged_attention.launches += 1
    return o


paged_attention.launches = 0
