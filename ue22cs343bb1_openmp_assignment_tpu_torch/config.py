"""Runtime system configuration.

The reference freezes all dimensions at compile time
(``assignment.c:6-10``: NUM_PROCS=4, CACHE_SIZE=4, MEM_SIZE=16,
MSG_BUFFER_SIZE=256, MAX_INSTR_NUM=32). Here every dimension is a runtime
parameter so a single TPU chip can step thousands of simulated cores; the
classmethod :meth:`SystemConfig.reference` reproduces the reference's
exact dimensions for byte-parity testing.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """Static (compile-time, shape-determining) simulation parameters.

    Hashable and frozen so it can be a `static_argnum` to `jax.jit`.
    """

    num_nodes: int = 4          # NUM_PROCS (assignment.c:6); parameterized
    cache_size: int = 4         # direct-mapped lines/node (assignment.c:7)
    mem_size: int = 16          # memory blocks/node (assignment.c:8)
    queue_capacity: int = 256   # mailbox slots/node (assignment.c:9)
    max_instrs: int = 32        # trace length cap/node (assignment.c:10)

    # Message-network semantics -------------------------------------------
    # 'mailbox': INV fan-out travels through mailboxes (exact reference
    #            semantics, needs num_nodes out-slots per node — use for
    #            parity configs, num_nodes <= 64).
    # 'scatter': INV applied as a direct vectorized scatter in the same
    #            cycle (the reference already assumes INV never fails and
    #            tracks no INV-ACKs, assignment.c:358-361; this is the
    #            scale path for thousands of nodes).
    inv_mode: str = "mailbox"

    # Overflow policy: 'drop' matches the reference's silent drop on a full
    # ring (assignment.c:754-762); drops are always counted in metrics.
    overflow_policy: str = "drop"

    # Fault injection: probability that an accepted message is dropped at
    # delivery anyway (seedable via state.fault_key). The reference's only
    # "fault" is the silent overflow drop (assignment.c:754-762); this
    # generalizes it into a testable stress knob for the failure-detection
    # surface (ops.failures): a dropped reply strands its requester, which
    # the stall watchdog then flags. 0.0 = off (default, zero cost).
    drop_prob: float = 0.0

    # Hit-burst depth of the synchronous transactional engine
    # (ops.sync_engine): per round each node retires up to this many
    # consecutive cache hits locally before attempting one coherence
    # transaction. Purely a throughput knob — hits are node-local, so any
    # depth realizes a legal schedule.
    drain_depth: int = 4

    # Transaction-window width of the synchronous transactional engine:
    # per round each node may commit up to this many coherence
    # transactions (read-miss / write-miss / upgrade), provided they
    # touch pairwise-distinct directory entries (fill targets and evicted
    # victims alike); mid-window cache hits retire only on entries the
    # node itself claimed earlier in the window, which keeps every
    # committed round a legal serialization of the reference machine
    # (ops/sync_engine.py `_round_step_multi` docstring). 1 = the
    # classic burst-plus-one-transaction round. Purely a throughput
    # knob: the per-round device-dispatch cost is roughly constant, so
    # wider windows retire more instructions per dispatch.
    txn_width: int = 1

    # Deep-window transactional engine (ops.deep_engine): per round each
    # node composes arbitrarily deep transaction chains on its OWN
    # directory entries (dense, gather-free — the dm table's row index
    # is the address, so a node's own slice aligns with the node axis)
    # and issues at most deep_slots remote events (fill requests /
    # eviction notices), which serialize per-entry through a scatter-min
    # lane and compose after the owning home's chain. Same protocol,
    # far more retired instructions per round on locality-heavy
    # workloads. The window length is drain_depth + txn_width, as for
    # the multi-transaction engine.
    deep_window: bool = False
    # per-node per-round budget of remote events (requests, eviction
    # notices, and remote-hit safety probes share these slots); overflow
    # stops the window for that round
    deep_slots: int = 8
    # per-node per-round budget of own-entry EM-owner value resolutions
    deep_ownerval_slots: int = 4
    # adaptive attempt-horizon slack: next round's attempt cap is
    # last round's retirement + slack (lane politeness: attempts past
    # the cap would claim per-entry lanes they rarely commit, starving
    # other nodes' events). Larger slack = more speculative depth; the
    # steady state solves n ~= c*(n + slack) for commit ratio c, so
    # slack directly scales committed window depth (PERF.md).
    deep_horizon_slack: int = 2
    # absorption waves: per round, up to deep_waves foreign events
    # compose per directory entry (wave 0 = the classic one winner per
    # entry; waves 1+ serialize additional FILL REQUESTS — mixed
    # read/write sequences included — against the previous wave's
    # composed row; per-line outcomes stay exact via the wave-stamp
    # fan-out encoding, ops/deep_engine). 1 = single-winner rounds.
    # Capped at 14 by the 4-bit wave-stamp fields in DM_ACT.
    deep_waves: int = 1
    # read-storm bulk grant (round 5): after the absorption waves, ALL
    # still-losing READ requests on an entry commit together as one
    # final pseudo-wave — reads commute, so k same-round readers
    # compose in one k-aggregated step (S count += k; an EM owner
    # flushes and downgrades via the wave stamps; U rows grant E to a
    # single reader, S to two or more — exactly the reference's
    # read-after-read serialization, assignment.c:211-236). From its
    # first storm slot onward a node's window is in the storm ZONE:
    # further reads (and gated EVICT_SHARED notices) join the same
    # terminal storm point, anything else truncates the window there
    # (program order; ops/deep_engine). The many-readers-one-entry
    # lever (lu's pivot rows, hotspot's read half); costs ~3 [Q, N]
    # index ops per round plus a reads-always-storm lane-key bit, so
    # off by default for low-contention or write-heavy workloads.
    deep_read_storm: bool = False
    # commit-prefix-exact marker/poison flags (round 5): derive the
    # home-side conflict flags from a lane-truncated flag-pass fold
    # instead of the full attempt horizon, eliminating the ghost
    # aborts that pinned committed depth (PERF.md stop-reason
    # anatomy). One extra fold pass + one extra [Q, N] gather per
    # round; False restores the round-4 attempt-based flags (A/B
    # lever, bench --no-exact-flags).
    deep_exact_flags: bool = True

    # Procedural workload (sync engine): when set (e.g. "uniform"),
    # instructions are computed per (node, index) from a counter-based
    # hash inside the round instead of gathered from a stored [N, T]
    # trace — O(1) trace memory for arbitrarily long runs, and one
    # fewer gather per round. Parameters are permille ints so the
    # config stays hashable/static. models.workloads.procedural_uniform
    # materializes the identical trace for cross-checking.
    procedural: str | None = None
    proc_local_permille: int = 800
    proc_write_permille: int = 500
    proc_seed: int = 0

    # Execute the round's node-local phase as fused Pallas TPU kernels
    # instead of XLA fusions: the burst phase of single-transaction
    # rounds (ops.pallas_burst) or the window fold + replay of
    # multi-transaction rounds (ops.pallas_window). Requires a
    # procedural workload (stored-trace windows need a dynamic gather
    # TPU Pallas cannot vectorize). Measured on the attached TPU:
    # +24% on the single path, +19% at txn_width=3 (PERF.md). OFF by
    # default because the CPU fallback is the Pallas interpreter,
    # which is impractically slow at full kernel size — bench.py turns
    # it on automatically when a TPU backend is attached.
    pallas_burst: bool = False

    # Execute the ENTIRE deep-engine round as one kernel: in the port,
    # the cooperative CUDA kernel of ops.deep_round_kernel (window
    # folds, arbitration, composition and fan-out between grid-wide
    # barriers, state in device memory); in the JAX package, the fused
    # Pallas kernel. Bit-identical to the fold path on supported
    # configs (deep_round_kernel.supported — no read-storm); round_step
    # runs the fold path otherwise. The config default is off; the
    # port's bench turns it on for the card (--fused-round auto).
    fused_round: bool = False

    # Coherence protocol variant. 'mesi' is the reference protocol and
    # the only one the hand-written ops/handlers.py implements; 'moesi'
    # and 'mesif' are expressed as declarative tables
    # (analysis/protocol_table.py) compiled to drop-in message phases.
    # The engine itself is protocol-agnostic — this field's one runtime
    # effect is widening the cache-state range invariant
    # (ops/invariants.py) to admit the variant's extra state (OWNED /
    # FORWARD, types.py), and it keys which table the analysis layer
    # pairs with a scope.
    protocol: str = "mesi"

    # Admission window (backpressure): maximum number of simultaneously
    # outstanding request transactions system-wide. The reference silently
    # drops on overflow (assignment.c:754-762), which at its dimensions is
    # unreachable but at scale livelocks: a dropped reply leaves its
    # requester blocked forever (SURVEY quirk 6). With a window W <= Q/6,
    # no mailbox can overflow (each in-flight transaction enqueues at most
    # ~6 messages against any single queue), so delivery is drop-free.
    # None = reference semantics (no gating).
    admission_window: int | None = None

    # Cross-shard mailbox transport for the sharded engines
    # (parallel/). 'all_to_all' is the shard_map + jax.lax.all_to_all
    # router (parallel/shardmap_comm.py); 'rdma' delivers lanes with a
    # Pallas remote-DMA ring kernel (parallel/rdma_comm.py,
    # pltpu.make_async_remote_copy with send/recv semaphores) that
    # never materializes the full [D*D] exchange tensor. Gated like
    # fused_round: rdma_comm.supported() decides whether the kernel
    # compiles natively (real TPU) or runs under the Pallas
    # interpreter (CPU CI — the correctness contract); unsupported
    # configs fall back to all_to_all. Single-device meshes bypass the
    # transport entirely.
    transport: str = "all_to_all"

    def __post_init__(self):
        if self.num_nodes < 1:
            raise ValueError("num_nodes must be >= 1")
        if self.deep_window and self.mem_size > (1 << 16):
            raise ValueError(
                "deep_window packs block indices in 16 bits; "
                "mem_size must be <= 65536")
        if self.deep_window and self.num_nodes > (1 << 16):
            raise ValueError(
                "deep_window packs requester ids in 16 bits (fan-out "
                "column); num_nodes must be <= 65536")
        if self.txn_width < 1:
            raise ValueError("txn_width must be >= 1")
        if not 1 <= self.deep_waves <= 14:
            raise ValueError(
                "deep_waves must be in [1, 14] (wave stamps pack into "
                "4-bit DM_ACT fields; see ops/deep_engine)")
        if self.deep_read_storm and self.deep_waves > 13:
            raise ValueError(
                "deep_read_storm uses the stamp one past the last "
                "wave, so deep_waves <= 13 when the storm is on "
                "(4-bit DM_ACT stamp fields)")
        if self.deep_read_storm and self.num_nodes > (1 << 15) - 1:
            raise ValueError(
                "deep_read_storm needs num_nodes <= 32767: the "
                "per-entry evictor count packs as ke << 16 in an "
                "int32 scatter-add (ke can reach num_nodes), and "
                "multi-slot storm rows use requester id 0xFFFF as "
                "the matches-nobody sentinel (ops/deep_engine)")
        if self.protocol not in ("mesi", "moesi", "mesif"):
            raise ValueError(f"bad protocol {self.protocol!r}")
        if self.transport not in ("all_to_all", "rdma"):
            raise ValueError(f"bad transport {self.transport!r}")
        if self.inv_mode not in ("mailbox", "scatter"):
            raise ValueError(f"bad inv_mode {self.inv_mode!r}")
        if self.inv_mode == "mailbox" and self.num_nodes > 64:
            raise ValueError(
                "inv_mode='mailbox' materializes num_nodes INV out-slots per "
                "node per cycle; use inv_mode='scatter' above 64 nodes")

    @property
    def allowed_cache_states(self) -> tuple:
        """Legal cache-line state values under cfg.protocol (plain ints,
        so the range invariant can static-unroll over them)."""
        from ue22cs343bb1_openmp_assignment_tpu_torch.types import CacheState
        base = (int(CacheState.MODIFIED), int(CacheState.EXCLUSIVE),
                int(CacheState.SHARED), int(CacheState.INVALID))
        if self.protocol == "moesi":
            return base + (int(CacheState.OWNED),)
        if self.protocol == "mesif":
            return base + (int(CacheState.FORWARD),)
        return base

    # -- address codec geometry -------------------------------------------
    @property
    def block_bits(self) -> int:
        """Bits of the block index inside an address.

        The reference packs (node, block) into one byte as two nibbles
        (``assignment.c:46-49,186-188``); with mem_size=16 the low nibble
        is exactly the block index. Generalized: block field is
        ceil(log2(mem_size)) bits, node id sits above it.
        """
        return max(1, (self.mem_size - 1).bit_length())

    @property
    def addr_bits(self) -> int:
        node_bits = max(1, (self.num_nodes - 1).bit_length())
        return self.block_bits + node_bits

    @property
    def invalid_address(self) -> int:
        """Sentinel for an empty cache line.

        The reference uses 0xFF (``assignment.c:815-817``); generalized to
        an address whose node field is out of range for any valid node.
        With reference dimensions this is exactly 0xFF.
        """
        if self.is_reference_compat:
            return 0xFF
        return (1 << (self.addr_bits + 4)) - 1

    @property
    def bitvec_words(self) -> int:
        """uint32 words per directory sharer-bitvector (tiled for large N).

        The reference uses a single byte (``assignment.c:63``), capping it
        at 8 nodes; we tile ceil(N/32) uint32 words.
        """
        return max(1, math.ceil(self.num_nodes / 32))

    @property
    def msg_bitvec_words(self) -> int:
        """uint32 words of sharer-bitvector payload per mailbox slot.

        Only REPLY_ID carries a sharer set (assignment.c:345,429), and
        only in mailbox INV mode — in scatter mode the home applies the
        invalidations itself when it processes the UPGRADE/WRITE_REQUEST
        (ops/handlers.py), so messages carry no bitvector and the mailbox
        payload shrinks to one dummy word. At 4096 nodes this is the
        difference between a 134 MB and a 1 MB mailbox tensor.
        """
        return self.bitvec_words if self.inv_mode == "mailbox" else 1

    @property
    def is_reference_compat(self) -> bool:
        """True when dimensions match the reference exactly (parity mode)."""
        return (self.num_nodes <= 8 and self.cache_size == 4
                and self.mem_size == 16 and self.max_instrs <= 32)

    # Out-slot layout for candidate messages emitted per node per cycle.
    # Program order within one node's cycle (defines intra-node FIFO order,
    # mirroring the reference's sequential sendMessage calls):
    #   slot 0            : primary send (home reply / flush-to-home /
    #                       frontend request / evict-notify)
    #   slot 1            : secondary send (FLUSH / FLUSH_INVACK to the
    #                       secondReceiver, assignment.c:282,498)
    #   slots 2..2+N-1    : INV fan-out (assignment.c:364-373), mailbox mode
    #   slot last         : eviction notice (sent after INVs in REPLY_ID,
    #                       assignment.c:364-378, and alone in other fills)
    @property
    def inv_slots(self) -> int:
        return self.num_nodes if self.inv_mode == "mailbox" else 0

    @property
    def out_slots(self) -> int:
        return 3 + self.inv_slots

    @classmethod
    def reference(cls, **overrides) -> "SystemConfig":
        """The reference's exact compile-time dimensions (assignment.c:6-10)."""
        base = dict(num_nodes=4, cache_size=4, mem_size=16,
                    queue_capacity=256, max_instrs=32, inv_mode="mailbox")
        base.update(overrides)
        return cls(**base)

    @classmethod
    def scale(cls, num_nodes: int, **overrides) -> "SystemConfig":
        """A large-N benchmark configuration (scatter INV, tiled bitvectors)."""
        base = dict(num_nodes=num_nodes, cache_size=4, mem_size=16,
                    queue_capacity=64, max_instrs=32, inv_mode="scatter")
        base.update(overrides)
        return cls(**base)
