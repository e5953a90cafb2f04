"""Multi-head latent attention (MLA) over a latent page pool, on Hopper: a
split-K decode kernel with its combine, and a chunked-prefill kernel. They
replace no TPU kernel: the JAX package has no MLA. They exist because
``paged_attention.cu`` and ``paged_flash_attention.cu`` read K and V per
head, and an MLA pool holds one row of ``R + Dr`` values a token
(``[c | rope(k_pe)]``, ``models.mla``) that every query head shares. The
CUDA source is ``csrc/paged_mla.cu``, built for ``R`` = 512 and ``Dr`` =
64 (kanana-2 and the DeepSeek-V3 family).

Both run the absorbed form. A query is ``q~ = [q_nope W_uk^T | q_pe]``
(``R + Dr`` wide, made by the caller); every head scores each latent row
over all ``R + Dr`` values and sums the rows' first ``R`` values (the
caller lifts the sum by ``W_uv``). Each latent row is read from its page
in place through the block table. Products run on the tensor cores (bf16
operands, f32 accumulation). Design notes in the source.

- **Decode** (``paged_mla_decode``): one lane's 32 heads against a tile of
  latent rows, so the heads share each row read: per key and layer the
  kernel reads ``R + Dr`` bf16 values (1,152 B) and does
  ``2 H (2R + Dr)`` operations, about 60 per byte, below the card's ridge
  (295): it is bound by the bytes. Split-K over keys: a grid of (lane,
  split) blocks, each over ``per`` keys, writes its unnormalised sum,
  maximum and denominator to a workspace, and a combine kernel merges the
  splits. The split count comes from shapes alone (:func:`decode_splits`),
  so a call can be captured. The new token's row is written into its page
  inside the call by the lane's first split; every split takes that row
  from the input rather than the pool, so no block reads a slot another
  is writing. It runs ``attn_mma.cuh``'s ``mma.sync`` design widened to
  MLA's rows (any page size): a block's warps split the 512 output
  columns, and the warps of one 16-row group each compute a part of the
  576-wide score product and sum the parts through shared memory.
- **Prefill** (``paged_mla_prefill``): the rows of a block are (token,
  head) pairs, token-major, 64 of them, so the heads of the same tokens
  share each tile of latent rows; causal by absolute position
  (``kv_pos <= q_offset + i``, ``kv_pos < kv_len``), stopping at the last
  key its rows can see. It runs on Hopper's warpgroup path
  (``csrc/sm90.cuh``): a producer warp loads Q once and each 32-key tile
  by TMA, a page's rows a box, into a four-stage ring; two consumer
  warpgroups take turns computing a tile's whole 64 x 32 x 576 score
  product with ``wgmma``, each runs the online softmax on its tile from
  the maxima the other published for the tile before, and each applies
  every tile's P to its own 256 of the 512 output columns (its own P from
  registers, the other's from shared memory). The absorbed form does
  ``2 H (2R + Dr)`` operations a query-key pair (69,632 at kanana's
  widths) against the published ``2 H (Dn + Dr + Dv)`` (20,480), 3.4
  times the count: expanding ``k_nope`` and ``v`` tile by tile would cost
  each block ``2 R H (Dn + Dv)`` operations a key, more again at any block
  a register file holds. At pack sizes it is bound by the tensor cores;
  a tile feeds its 64 rows about 121 operations a byte read from L2. On
  one H100 a 2,048-token pack at 26,000 keys takes 7.88 ms of device
  time, 489 TFLOP/s of absorbed work. The page size must be a multiple of 8
  that divides ``PREFILL_KEYS`` or is a multiple of it (checked): a TMA
  box holds one page's rows of a tile.

On a CPU tensor the wrappers run the plain versions
(``ref.paged_mla_decode_ref``, ``ref.paged_mla_prefill_ref``); on a CUDA
tensor they launch the kernels or raise. The device records read
``paged_mla_decode_split``, ``paged_mla_decode_combine`` and
``paged_mla_prefill_kernel``. The kernels take bf16 only, ``R`` = 512,
``Dr`` = 64 and, in decode, 32 heads; q, the pool and the new rows start
16-byte aligned (checked). ``.launches`` counts wrapper calls (a decode
call is two kernels, counted once). No gradient: an input that requires
grad under grad mode raises (``_grad.refuse_grad``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _grad
from repro_torch.kernels.ref import paged_mla_decode_ref, paged_mla_prefill_ref

# the widths and block shapes of csrc/paged_mla.cu (paged_mla_shape)
RANK, ROPE, DECODE_HEADS, DECODE_KEYS, PREFILL_ROWS, PREFILL_KEYS = (
    512, 64, 32, 32, 64, 32)
TARGET_BLOCKS = 264        # decode blocks a call aims for: two an SM
MIN_KEYS_PER_SPLIT = 256
_vp, _int = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_mla")
    if lib.paged_mla_decode.argtypes is None:
        lib.paged_mla_shape.argtypes = [_int]
        lib.paged_mla_shape.restype = _int
        got = tuple(lib.paged_mla_shape(i) for i in range(6))
        want = (RANK, ROPE, DECODE_HEADS, DECODE_KEYS, PREFILL_ROWS,
                PREFILL_KEYS)
        if got != want:
            raise RuntimeError(f"paged_mla.cu is built for {got}, the "
                               f"wrapper expects {want}")
        lib.paged_mla_decode.argtypes = [_vp] * 10 + [_int] * 5 + [
            ctypes.c_float, _vp]
        lib.paged_mla_decode.restype = _int
        lib.paged_mla_prefill.argtypes = [_vp] * 6 + [_int] * 6 + [
            ctypes.c_float, _vp]
        lib.paged_mla_prefill.restype = _int
        lib.paged_mla_prefill_smem.argtypes = []
        lib.paged_mla_prefill_smem.restype = _int
    return lib


def _check(name, q, latent_pages, block_table, ints, rank: int):
    H, W = q.shape[-2], q.shape[-1]
    if latent_pages.dim() != 3 or latent_pages.shape[2] != W:
        raise ValueError(f"{name}: pages {tuple(latent_pages.shape)} are not "
                         f"(P, page, {W})")
    if (rank, W - rank) != (RANK, ROPE):
        raise ValueError(f"{name}: rank {rank}, rope {W - rank}; the kernel "
                         f"is built for {RANK} and {ROPE}")
    if q.dtype != torch.bfloat16 or latent_pages.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bf16, not {q.dtype}")
    for t in (q, latent_pages, block_table, *ints):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")
    for t in (block_table, *ints):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: tables, lengths and slots must be "
                            "int32")
    for t in (q, latent_pages):
        if t.data_ptr() % 16:       # cp.async's 16-byte rows; TMA's base
            raise ValueError(f"{name}: q and the pool must start on a "
                             "16-byte boundary")
    return H


def decode_splits(batch: int, max_keys: int):
    """(splits, keys per split) of a decode call: about TARGET_BLOCKS
    blocks, each over at least MIN_KEYS_PER_SPLIT keys (a multiple of
    DECODE_KEYS), from the call's shapes alone."""
    most = -(-max_keys // MIN_KEYS_PER_SPLIT)
    splits = max(1, min(most, -(-TARGET_BLOCKS // max(1, batch))))
    per = -(-max_keys // splits)
    per = -(-per // DECODE_KEYS) * DECODE_KEYS
    return -(-max_keys // per), per


def paged_mla_decode(q, latent_pages, block_table, lengths, latent_new,
                     write_pages, write_offsets, *, scale: float,
                     rank: int):
    """q: (B, H, R + Dr) absorbed queries; latent_pages: (P, page, R + Dr);
    block_table: (B, max_pages) int32; lengths: (B,) int32 valid keys after
    this step's write; latent_new: (B, R + Dr) the new rows, written in
    place at ``write_pages``/``write_offsets`` (B,) (slot contract:
    position ``lengths - 1``). Returns (B, H, R)."""
    if q.device.type == "cpu":
        return paged_mla_decode_ref(q, latent_pages, block_table, lengths,
                                    scale=scale, rank=rank,
                                    latent_new=latent_new,
                                    write_pages=write_pages,
                                    write_offsets=write_offsets)
    if q.device.type != "cuda":
        raise ValueError(f"paged_mla_decode: no kernel for {q.device}")
    _grad.refuse_grad("paged_mla_decode", q, latent_pages, latent_new)
    H = _check("paged_mla_decode", q, latent_pages, block_table,
               (lengths, write_pages, write_offsets), rank)
    B, _, W = q.shape
    if H != DECODE_HEADS:
        raise ValueError(f"paged_mla_decode: {H} heads; the kernel is built "
                         f"for {DECODE_HEADS}")
    if tuple(latent_new.shape) != (B, W) or latent_new.dtype != q.dtype or \
            not latent_new.is_contiguous() or latent_new.data_ptr() % 16 or \
            latent_new.device != q.device:
        raise ValueError("latent_new must be contiguous (B, R + Dr) in q's "
                         "dtype and device, 16-byte aligned")
    o = torch.empty((B, H, rank), dtype=q.dtype, device=q.device)
    if B == 0:
        return o
    page, maxp = latent_pages.shape[1], block_table.shape[1]
    splits, per = decode_splits(B, maxp * page)
    acc = torch.empty((B, splits, H, rank), dtype=torch.float32,
                      device=q.device)
    ml = torch.empty((B, splits, H, 2), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_mla_decode(
            q.data_ptr(), latent_pages.data_ptr(), block_table.data_ptr(),
            lengths.data_ptr(), latent_new.data_ptr(), write_pages.data_ptr(),
            write_offsets.data_ptr(), acc.data_ptr(), ml.data_ptr(),
            o.data_ptr(), B, maxp, page, per, splits, scale, stream)
    if rc != 0:
        raise RuntimeError(f"paged_mla_decode launch failed: CUDA error {rc}")
    paged_mla_decode.launches += 1
    return o


def paged_mla_prefill(q, latent_pages, block_table, kv_len, q_offset, *,
                      scale: float, rank: int):
    """q: (B, Sq, H, R + Dr) absorbed queries; latent_pages: (P, page,
    R + Dr), the chunk's own rows already written; block_table: (B, Np)
    int32; kv_len/q_offset: (B,) int32 on the device. Returns (B, Sq, H,
    R)."""
    if q.device.type == "cpu":
        return paged_mla_prefill_ref(q, latent_pages, block_table, kv_len,
                                     q_offset, scale=scale, rank=rank)
    if q.device.type != "cuda":
        raise ValueError(f"paged_mla_prefill: no kernel for {q.device}")
    _grad.refuse_grad("paged_mla_prefill", q, latent_pages)
    H = _check("paged_mla_prefill", q, latent_pages, block_table,
               (kv_len, q_offset), rank)
    B, Sq = q.shape[:2]
    n_pages, page = latent_pages.shape[:2]
    if page % 8 or (PREFILL_KEYS % page and page % PREFILL_KEYS):
        raise ValueError(f"paged_mla_prefill: page size {page}; the kernel "
                         f"takes a multiple of 8 that divides {PREFILL_KEYS} "
                         f"or is a multiple of it")
    o = torch.empty((B, Sq, H, rank), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0:
        return o
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_mla_prefill(
            q.data_ptr(), latent_pages.data_ptr(), block_table.data_ptr(),
            kv_len.data_ptr(), q_offset.data_ptr(), o.data_ptr(), B, Sq, H,
            n_pages, block_table.shape[1], page, scale, stream)
    if rc != 0:
        raise RuntimeError(f"paged_mla_prefill launch failed: CUDA error "
                           f"{rc}")
    paged_mla_prefill.launches += 1
    return o


paged_mla_decode.launches = 0
paged_mla_prefill.launches = 0
