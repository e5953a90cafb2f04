"""Paged decode attention on Hopper: ``paged_attention_fused`` and the
read-only ``paged_attention``.

Replaces the Pallas TPU kernels ``paged_attention_fused``
(``src/repro/kernels/paged_attention.py:143``, body ``_fused_kernel``) and
``paged_attention`` (``:217``, body ``_kernel``). Both launch one CUDA
source, ``csrc/paged_attention.cu``: one body templated on the element
type (float32, bfloat16), the head dim (32, 64, 128) and a bound on the
query heads per kv head (at most 8), with the fused write a runtime flag.

What bounds it on the H100: decode reads every valid KV byte of the batch
once (``2 * sum(lengths) * Hkv * D * itemsize``) and does about ``4 * G * D``
flops per KV token, far below the ~295 flops per byte where the tensor
cores become the limit, so the memory rate sets the bound. The design is
split-K (flash-decoding): the grid is ``(Hkv, B, S)``, each block walks
``pps`` pages of one lane's table, its rows copied 16 bytes a thread with
``cp.async`` into a ring in shared memory (two stages in flight while one
is computed), and writes an f32 partial ``(m, l, acc)`` per query head to
a workspace; a second kernel combines the partials (and, fused, the new
token's own) into ``o``.
:func:`_split_plan` picks ``pps`` and ``S`` on the host from the shapes
alone, never from ``lengths`` (no sync). One body serves f32 and bf16.

On a CPU tensor the wrappers run the plain versions in
:mod:`repro_torch.kernels.ref`; on a CUDA tensor they launch the kernel or
raise. Each wrapper counts its launches in ``.launches``, one per call (a
call runs the split kernel and its combine). Block-table and slot indices
are trusted (they come from the engine's binding map); shapes, dtypes,
devices, contiguity and the 16-byte alignment of q, the pools and the new
KV are checked. The kernels have no gradient (no training path runs
them): on the card, an input that requires grad under grad mode raises
(``_grad.refuse_grad``) rather than come back detached.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _grad
from repro_torch.kernels.ref import paged_attention_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_MAX_G = 8                   # query heads per kv head one block carries
_KEYS_PER_SPLIT = 128        # the smallest split
_MAX_BLOCKS = 512            # about 4 blocks an SM on the H100's 132
_MAX_SPLITS = 64             # partials per query head (the .cu kMaxSplits)
_vp, _int = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [_int, _int, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                       _vp, _vp, _vp, _int, _int, _int, _int, _int, _int,
                       _int, _int, ctypes.c_float, _vp]
        fn.restype = ctypes.c_int
    return lib


def _split_plan(B: int, Hkv: int, maxp: int, page: int):
    """``(pps, S)``: each block walks ``pps`` pages of one lane's table and
    the grid has ``S`` splits per (lane, kv head), ``S * pps >= maxp``.
    Splits start at ``_KEYS_PER_SPLIT`` keys (whole pages) and double
    while the grid would exceed ``_MAX_BLOCKS`` blocks or ``_MAX_SPLITS``
    splits. Shapes only: ``lengths`` stays on the device, and splits past
    a lane's length exit at once."""
    pps = max(1, -(-_KEYS_PER_SPLIT // page))
    S = -(-maxp // pps)
    while S > 1 and (B * Hkv * S > _MAX_BLOCKS or S > _MAX_SPLITS):
        pps *= 2
        S = -(-maxp // pps)
    return pps, S


def _check(q, k_pages, v_pages, block_table, lengths, k_new=None,
           v_new=None, write_pages=None, write_offsets=None):
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("q must be (B, Hq, D) and pages (P, page, Hkv, D)")
    B, Hq, D = q.shape
    P, page, Hkv, Dk = k_pages.shape
    if Dk != D or v_pages.shape != k_pages.shape or Hq % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if D not in _HEAD_DIMS or D * q.element_size() % 16:
        raise ValueError(f"head dim {D} not in {_HEAD_DIMS} (rows are read "
                         "as 16-byte vectors)")
    if Hq // Hkv > _MAX_G:
        raise ValueError(f"{Hq // Hkv} query heads per kv head exceed one "
                         "block")
    if block_table.dim() != 2 or block_table.shape[0] != B or \
            tuple(lengths.shape) != (B,):
        raise ValueError("block_table must be (B, max_pages), lengths (B,)")
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
    names = ("q", "k_pages", "v_pages", None, None, "k_new", "v_new")
    for name, t in zip(names, tensors):
        if name is None:
            continue
        if t.dtype != q.dtype:
            raise TypeError(f"pool/new KV dtype {t.dtype} != q {q.dtype}")
        if t.data_ptr() % 16:      # the 16-byte vector loads and stores
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _launch(fused, q, k_pages, v_pages, block_table, lengths, k_new, v_new,
            write_pages, write_offsets):
    B, Hq, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    maxp = block_table.shape[1]
    pps, S = _split_plan(B, Hkv, maxp, page)
    o = torch.empty_like(q)
    ws = torch.empty(B * Hq * S * (D + 2), dtype=torch.float32,
                     device=q.device)
    lib = _lib()
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_decode_attention(
            _DTYPE_CODE[q.dtype], int(fused), q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), block_table.data_ptr(),
            lengths.data_ptr(), ptr(k_new), ptr(v_new), ptr(write_pages),
            ptr(write_offsets), ws.data_ptr(), o.data_ptr(), B, maxp, page,
            Hkv, Hq // Hkv, D, pps, S, D ** -0.5, stream)
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
    _grad.refuse_grad("paged_attention_fused", q, k_pages, v_pages, k_new,
                      v_new)
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
    _grad.refuse_grad("paged_attention", q, k_pages, v_pages)
    _check(q, k_pages, v_pages, block_table, lengths)
    if q.shape[0] == 0:
        return torch.empty_like(q)
    o = _launch(False, q, k_pages, v_pages, block_table, lengths, None, None,
                None, None)
    paged_attention.launches += 1
    return o


paged_attention.launches = 0
