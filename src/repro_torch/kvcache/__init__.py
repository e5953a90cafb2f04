"""Tiered KV-state subsystem.

Six layers that together replace the counter-only block manager:

* ``pool``        — block-identity pool: per-block refcounts, copy-on-write,
                    radix-cached (evictable) blocks, per-session leases.
* ``radix``       — prefix index over hashed token chunks: sessions sharing a
                    repository context share physical KV blocks.
* ``host_tier``   — host-DRAM offload tier with a PCIe-bandwidth cost model;
                    the third retention outcome (PIN / OFFLOAD / DROP).
* ``disk_tier``   — NVMe cold tier: per-op latency + asymmetric read/write
                    bandwidth + bounded queue depth; modeled and real-file
                    (``DiskFileStore``) backends.
* ``tiers``       — ``TieredStore``, the host+disk orchestrator: net-benefit
                    demotion of cold host entries, promote-on-access with the
                    staged two-hop restore, per-tier stats; the fourth
                    retention outcome (OFFLOAD_DISK).
* ``swap_stream`` — background worker + double-buffered staging that moves
                    every tier crossing (D2H/H2D page copies, NVMe
                    spill/fill) off the engine's critical path; tier
                    ``ready`` gates on its transfer futures.
"""
from repro_torch.kvcache.disk_tier import DiskFileStore, DiskTier, DiskTierConfig
from repro_torch.kvcache.host_tier import HostTier, HostTierConfig
from repro_torch.kvcache.pool import BlockPool, DeviceBindingMap, TieredPoolProbe
from repro_torch.kvcache.radix import (RadixIndex, chunk_key_digest,
                                 estimate_digest_match)
from repro_torch.kvcache.swap_stream import (StagingBuffers, SwapStream,
                                       TransferFuture, resolved_future)
from repro_torch.kvcache.tiers import TieredStore

__all__ = ["BlockPool", "DeviceBindingMap", "TieredPoolProbe", "RadixIndex",
           "HostTier", "HostTierConfig", "DiskTier", "DiskTierConfig",
           "DiskFileStore", "TieredStore", "SwapStream", "StagingBuffers",
           "TransferFuture", "resolved_future", "chunk_key_digest",
           "estimate_digest_match"]
