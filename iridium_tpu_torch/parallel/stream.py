"""The sharded pipeline: the decode of one stream over the ranks of a
process group (one card each), the port of iridium_tpu/parallel/stream.py.

The JAX package runs its mesh from one process with `shard_map`; here every
rank is a process and the mesh axis is the group (`distributed.Mesh`).
Rank r holds time slice r of every block (samples [r ls, (r + 1) ls), ls =
block_samples / n) and, per block, enqueues:

  detect   the spectrogram of its slice (frames_per_block / n frames), then
           - replicated (default, :328-351): `all_gather` of the slices'
             |X|^2 into the block's (frames_per_block, F) rows, and the
             scan `detect_scan.resolve_impl` picks (the scan kernel where
             it takes the shape, else detect_fast, whose kernel runs on
             the card; "exact" is detect.py) over all of them, the same
             on every rank: the gone table and the burst ids are the
             single card's;
           - binshard (:353-398): `all_to_all_single` from time slices to
             bin slices (bins [r own, (r + 1) own)), a ring exchange of
             `halo` bins each way, and detect_fast over the rank's bins
             with its per-frame coupling pair summed over the ranks by
             `all_reduce` (detect.py's frame step with "exact"): on the
             card detect_fast's kernel, each frame two launches around
             the `all_reduce` of the pair in the kernel's scratch; at
             world size 1 the block's frames replayed as one CUDA graph,
             captured once per count of active frames
             (`detect_fast.scan_fast_split`, `SplitGraphs`), across cards
             a frame at a time from the host (`scan_fast_steps`); ids are
             offset by the rank and strided by n.
             The rank tables are gathered with `all_gather`.
  stream   its slice with the l_ext samples before it, [left | slice |
           zeros(l_ext)], the left part by a ring of k_hops shifts (k_hops
           <= 2, :489-502) or from an `all_gather` of the block (:503-507),
           the samples before the block from the rolling tail, which every
           rank keeps: the block's last samples come to it by `all_gather`
           (l_ext can exceed a slice, and a block).

and per group of `agg_blocks` blocks, after the detect steps:

  process  per block, the routing of the gone bursts (:518-549): owner =
           the rank whose slice holds the extraction window's end; the
           rank keeps its own, each class's members in a window of the
           class's batch (`pipeline.BurstDecoder`), and runs the class
           batches through the single card's `BurstClass` (the fused
           front-end kernel at 10 MHz, the window gather elsewhere) at the
           JAX package's sharded capacities (:445-460). On the card the
           routing and each class batch replay as CUDA graphs; a class
           with no member on this rank runs nothing (:587). No collective
           runs inside these graphs (binshard's detect graph at world
           size 1 holds its frames' all_reduces).
  result   each rank's buffer per block, [head 6 | class counts 3 | meta
           per class | table rows 6 x batch per class | packed rows per
           class], stacked over the group, `all_gather`ed, and copied to
           the host once on every rank, so that stats, frames and overflow
           rounds agree everywhere (:758-771). A class with more members on
           some rank than its batch takes another round on every rank.

The collectives run on the current stream's order (NCCL waits for the
work enqueued before it and the stream waits for NCCL), so a block is not
read before its upload has run. Only rank 0 yields frames from `run_file`
and `run_array`; `run_blocks` gives every rank the same lists. A stream
that only rank 0 reads (stdin) reaches every rank through `share_blocks`,
one broadcast a block.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist

from .. import device as device_mod
from ..config import DetectorConfig, DownmixConfig
from ..dsp import detect, detect_fast, detect_scan
from ..dsp import state as state_mod
from ..io import native
from ..ops import window_gather
from ..runtime import pipeline as pl
from . import distributed

DEPTH = 3        # groups in flight before the oldest is finished


@dataclasses.dataclass
class _Block:
    """One block after its detect step: this rank's stream planes (2,
    stream_len), the gone tables the routing reads (1 or n, G + 1, 6) and
    the absolute index of the block's first sample."""
    planes: torch.Tensor
    tables: torch.Tensor
    base: int


class ShardedPipeline(pl.BurstDecoder):
    """Offline decode over the ranks of `mesh` (`distributed.make_mesh()`;
    None joins or makes the group with `distributed.initialize`). `device`
    None is the rank's CUDA device and raises without one; "cpu" runs the
    plain versions of the kernels over gloo. `detect_mode` "replicated" or
    "binshard", `detect_impl` as `Pipeline`'s (binshard takes "auto" or
    "fast", which are detect_fast, or "exact"; the scan kernel has no bin
    range). `burst_batch`, `group_jobs` and `agg_blocks` as in the JAX
    package's ShardedPipeline (iridium_tpu/parallel/stream.py:78-92)."""

    def __init__(self,
                 det_cfg: DetectorConfig,
                 dm_cfg: DownmixConfig | None = None,
                 mesh: distributed.Mesh | None = None,
                 burst_batch: int = 8,
                 use_gardner: bool = True,
                 start_time_ns: int | None = None,
                 want_llr: bool = True,
                 detect_impl: str = "auto",
                 group_jobs: int = 2,
                 agg_blocks: int = 4,
                 detect_mode: str = "replicated",
                 device: str | torch.device | None = None):
        if detect_mode not in ("replicated", "binshard"):
            raise ValueError(f"detect_mode {detect_mode!r}: expected "
                             "'replicated' or 'binshard'")
        dev = device_mod.resolve(device)
        if mesh is None:
            distributed.initialize(device=dev)
            mesh = distributed.make_mesh()
        if mesh.device.type != dev.type:
            raise ValueError(f"device {dev} on a mesh of {mesh.device} ranks")
        super().__init__(det_cfg, dm_cfg, mesh.device, use_gardner, want_llr)
        self.mesh = mesh
        self.n, self.rank = mesh.n, mesh.rank
        p, n = self.p, self.n
        F = p.fft_size
        if F % n or p.frames_per_block % n:
            raise ValueError(f"fft_size {F} and frames_per_block "
                             f"{p.frames_per_block} must divide by {n} ranks")
        self.replicated = detect_mode == "replicated"
        self.own_bins = F // n
        # two mask widths: second-order masking chains across the border
        # (:127-136)
        self.halo = 2 * (p.burst_width_bins // 2) + 1
        if not self.replicated and self.halo > self.own_bins:
            raise ValueError("bin slice narrower than the burst mask halo")
        self.n_bins_local = self.own_bins + 2 * self.halo
        self.n_tables = 1 if self.replicated else n
        self.slice_len = p.block_samples // n
        self.frames_local = p.frames_per_block // n
        self.agg_blocks = max(agg_blocks, 1)
        # this rank's stream: [left | slice | zeros(l_ext)]
        self.stream_len = self.slice_len + 2 * self.l_ext
        # ring shifts for a left part of l_ext samples
        self.k_hops = -(-self.l_ext // self.slice_len)
        # the sharded capacities (:445-460)
        J, Bb = max(group_jobs, 1), burst_batch
        Bl = max(2, Bb // 8)
        self.classes = self._burst_classes((J // 2, J // 6, J // 12),
                                           (2 * Bb, 3 * Bl, 3 * Bl))
        self._scan, self._init_state = self._build_detect(detect_impl)
        self._graph = None            # card only
        self._local = None            # this rank's slice on the card
        # (start, end, timing key) around collectives and detect graphs
        self._events: list = []
        self.reset(start_time_ns)

    def _build_detect(self, detect_impl: str):
        """(scan(mag2, state, n_valid) -> state, init_state()) for the
        mode; sets `detect_impl` to what it resolved to."""
        p, n, r = self.p, self.n, self.rank
        F, dev = p.fft_size, self.device
        idxs = np.arange(p.frames_per_block) * F
        if self.replicated:
            impl = detect_scan.resolve_impl(p, detect_impl)
            if impl == "scan":
                scan = lambda m, st, nv: detect_scan.scan(m, st, nv, p)  # noqa: E731
            elif impl == "fast":
                scan = detect_fast.make_scan_fast(p)
            else:
                step = detect.make_frame_step(p)
                scan = lambda m, st, nv: detect.run_state_machine(  # noqa: E731
                    m, idxs, idxs + F <= nv, st, step)
            init = (detect.init_state if impl == "exact"
                    else state_mod.init_state)
            self.detect_impl = impl
            return scan, lambda: init(p, dev)
        if detect_impl == "scan":
            raise ValueError("the scan kernel has no bin range: binshard "
                             "runs detect_fast ('auto', 'fast') or 'exact'")
        if detect_impl not in ("auto", "fast", "exact"):
            raise ValueError(f"detect_impl {detect_impl!r}")
        own, FL = self.own_bins, self.n_bins_local
        rng = dict(bin_lo=r * own - self.halo, own_lo=r * own,
                   own_hi=(r + 1) * own)
        if detect_impl == "exact":
            step = detect.make_frame_step(p, global_sum=self._all_sum,
                                          n_bins=FL, id_stride=n, **rng)
            scan = lambda m, st, nv: detect.run_state_machine(  # noqa: E731
                m, idxs, idxs + F <= nv, st, step)
            self.detect_impl = "exact"
            return scan, lambda: detect.init_state(p, dev, n_bins=FL,
                                                   id_offset=r)
        # the kernel's split on the card (two launches a frame around the
        # pair's all_reduce; at world size 1 a block's frames as one CUDA
        # graph, across cards from the host until a graph holding NCCL's
        # all_reduces has run there), the twin on the CPU
        graph = n == 1
        run = detect_fast.make_scan_fast(p, FL, coupling_sum=self._all_sum,
                                         id_stride=n, graph=graph)
        self.split_graphs = run.graphs
        self.detect_impl = "fast"

        def scan(m, st, nv):
            if dev.type != "cuda" or not graph:
                return run(m, st, nv, **rng)
            # the replay is timed as one span; its all_reduces count by
            # frames
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = run(m, st, nv, **rng)
            b.record()
            self._events.append((a, b, "detect_graph"))
            self.timing["n_collectives"] += detect_fast.active_frames(p, nv)
            return out
        return scan, lambda: state_mod.init_state(p, dev, id_offset=r,
                                                  n_bins=FL)

    def reset(self, start_time_ns: int | None = None) -> None:
        """Fresh stream state; CUDA graphs and buffers are kept."""
        self.state = self._init_state()
        self.tail = torch.zeros(self.l_ext, dtype=torch.complex64,
                                device=self.device)
        self._rebase = False
        self.base_index = 0
        self.prev_tagged = 0
        self.stats = pl.PipelineStats()
        self.start_time_ns = start_time_ns
        self._noise_sum = 0.0         # owned bins' baseline sums, all ranks
        self._peak = 0.0
        # host seconds per stage under the single card's keys, and
        # `collectives`: the device seconds (host on the CPU) between the
        # start and the end of every collective, its wait for the slowest
        # rank included, `n_collectives`, `detect_graph`: the device
        # seconds of binshard's detect graphs on the card at world size 1
        # (the kernel's launches and the all_reduce of every frame, which
        # n_collectives counts), and
        # `left_ring` / `left_gather`: the blocks whose left part came by
        # ring shifts or by the gathered block
        self.timing = collections.Counter()

    # ---- collectives ----

    def _coll(self, fn, *args) -> None:
        """Run one collective, timed; one captured into a CUDA graph is
        neither timed nor counted here (its graph's replay is)."""
        if (self.device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            fn(*args)
            return
        self.timing["n_collectives"] += 1
        if self.device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            self._events.append((a, b, "collectives"))
        else:
            t0 = time.perf_counter()
            fn(*args)
            self.timing["collectives"] += time.perf_counter() - t0

    def _drain_events(self) -> None:
        """Add the finished collectives' and detect graphs' device times
        to the timing."""
        while self._events and self._events[0][1].query():
            a, b, key = self._events.pop(0)
            self.timing[key] += a.elapsed_time(b) / 1e3

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(n * len(x), ...) : every rank's x in rank order."""
        out = torch.empty((self.n * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        self._coll(dist.all_gather_into_tensor, out, x.contiguous())
        return out

    def _all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the ranks: the detectors' coupling hook. An
        int64 tensor on the device (detect_fast's pair in its kernel's
        scratch) is summed in place and returned; anything else is summed
        in an int64 copy on the device."""
        t = x
        if (x.device.type != self.device.type or x.dtype != torch.int64
                or not x.is_contiguous()):
            t = x.to(self.device, torch.int64, copy=True)
        self._coll(dist.all_reduce, t)
        return t

    def _exchange(self, pairs) -> list:
        """Point-to-point: [(tensor to send, to rank, tensor to receive
        into, from rank, tag)], all at once."""
        ops = []
        for send, to, recv, frm, tag in pairs:
            ops += [dist.P2POp(dist.isend, send, to, tag=tag),
                    dist.P2POp(dist.irecv, recv, frm, tag=tag)]

        def run():
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        self._coll(run)
        return [recv for _, _, recv, _, _ in pairs]

    def _ring_shift(self, x: torch.Tensor) -> torch.Tensor:
        """The previous rank's x (a `ppermute` i -> i + 1)."""
        out = torch.empty_like(x)
        n, r = self.n, self.rank
        self._exchange([(torch.view_as_real(x), (r + 1) % n,
                         torch.view_as_real(out), (r - 1) % n, 0)])
        return out

    # ---- detect step ----

    def _upload(self, samples) -> torch.Tensor:
        """This rank's slice of the block on the device. The native
        reader's block (pinned on the card) is copied; its buffer goes
        back to the reader after the copy has run. A numpy block's slice
        is copied from pageable memory."""
        r0, ls = self.rank * self.slice_len, self.slice_len
        if isinstance(samples, torch.Tensor):
            part = samples[r0:r0 + ls]
            if self.device.type == "cpu":
                return part
            if self._local is None:
                self._local = torch.empty(ls, dtype=torch.complex64,
                                          device=self.device)
            self._local.copy_(part, non_blocking=True)
            return self._local
        x = torch.from_numpy(np.ascontiguousarray(samples[r0:r0 + ls],
                                                  np.complex64))
        return x.to(self.device)

    def _bin_slice(self, mag2_loc: torch.Tensor) -> torch.Tensor:
        """This rank's time slice of |X|^2 -> every frame of its bins with
        a halo of `halo` bins each side (frames_per_block, n_bins_local):
        the all_to_all at :369-370 and the ring halos at :371-372."""
        n, r, own, h = self.n, self.rank, self.own_bins, self.halo
        x = mag2_loc.reshape(self.frames_local, n, own).transpose(0, 1)
        magT = torch.empty((n, self.frames_local, own), dtype=x.dtype,
                           device=x.device)
        self._coll(dist.all_to_all_single, magT, x.contiguous())
        magT = magT.reshape(n * self.frames_local, own)
        if n == 1:
            # the ring to itself: the spectrum's own edges
            left, right = magT[:, -h:], magT[:, :h]
        else:
            left, right = self._exchange([
                (magT[:, -h:].contiguous(), (r + 1) % n,
                 torch.empty_like(magT[:, :h]), (r - 1) % n, 0),
                (magT[:, :h].contiguous(), (r - 1) % n,
                 torch.empty_like(magT[:, :h]), (r + 1) % n, 1)])
        return torch.cat([left, magT, right], 1)

    def _table(self) -> torch.Tensor:
        """The rank's gone table (G + 1, 6) i32: the head row [g_count,
        n_tagged, burst_dropped, create_waits, owned bins' baseline sum
        (f32 bits), peak dB (f32 bits)], then [id, start, stop, bin, mag,
        noise] rows (mag and noise as f32 bits)."""
        st = self.state
        zero = st.g_count * 0
        bsum = (st.baseline_sum if self.replicated else
                st.baseline_sum[self.halo:self.halo + self.own_bins])
        head = torch.stack(
            [st.g_count, st.n_tagged, getattr(st, "burst_dropped", zero),
             getattr(st, "create_waits", zero),
             bsum.sum().view(torch.int32), st.floats[0].view(torch.int32)])
        rows = torch.stack(
            [st.g_id, st.g_start, st.g_stop, st.g_bin,
             st.g_mag.view(torch.int32), st.g_noise.view(torch.int32)], 1)
        return torch.cat([head[None], rows])

    def _stream(self, local: torch.Tensor) -> torch.Tensor:
        """[left | local | zeros(l_ext)] as (2, stream_len) f32 planes, and
        the rolling tail advanced past this block."""
        n, r, ls, L = self.n, self.rank, self.slice_len, self.l_ext
        k = self.k_hops
        tail = self.tail
        T = min(L, self.p.block_samples)
        if k <= 2:
            # the previous ranks' slices by ring shifts; before rank 0, the
            # tail (:489-502)
            hist = torch.cat([torch.zeros(k * ls - L, dtype=tail.dtype,
                                          device=tail.device), tail])
            parts, cur = [], local
            for h in range(k):
                src = r - h - 1
                if h < n - 1:
                    cur = self._ring_shift(cur)
                parts.append(cur if src >= 0
                             else hist[(k + src) * ls:(k + src + 1) * ls])
            left = torch.cat(parts[::-1])[-L:]
            # the block's last T samples: on the last ranks
            end = self._all_gather(local[-min(ls, T):])[-T:]
            self.timing["left_ring"] += 1
        else:
            # windows longer than two slices: the whole block (:503-507)
            blk = self._all_gather(local)
            left = torch.cat([tail, blk])[r * ls:r * ls + L]
            end = blk[-T:]
            self.timing["left_gather"] += 1
        self.tail = torch.cat([tail, end])[-L:]
        planes = torch.empty((2, self.stream_len), dtype=torch.float32,
                             device=local.device)
        planes[:, :L] = torch.view_as_real(left).T
        planes[:, L:L + ls] = torch.view_as_real(local).T
        planes[:, L + ls:] = 0
        return planes

    def _dispatch_step(self, samples, n_valid: int) -> _Block:
        """Enqueue one block's detect step and stream."""
        p = self.p
        if self.start_time_ns is None:
            self.start_time_ns = time.time_ns()
        t0 = time.perf_counter()
        local = self._upload(samples)
        if self._rebase:
            state_mod.rebase_(self.state, p.block_samples)
        mag2 = detect_scan.spectrogram(local, p, self._det_window,
                                       self.frames_local)
        if self.replicated:
            mag2 = self._all_gather(mag2)
        else:
            mag2 = self._bin_slice(mag2)
        self.state = self._scan(mag2, self.state, n_valid)
        table = self._table()
        tables = (table[None] if self.replicated
                  else self._all_gather(table[None]))
        blk = _Block(self._stream(local), tables, self.base_index)
        self._rebase = True
        self.stats.n_samples += n_valid
        self.base_index += p.block_samples
        self.timing["step_dispatch"] += time.perf_counter() - t0
        self.timing["n_blocks"] += 1
        return blk

    # ---- process step ----

    def route(self, tables: torch.Tensor, floor: torch.Tensor, skips):
        """The routing of one block's gone bursts on this rank (:510-585):
        run-start clamp at `floor` (= -the block's absolute start),
        extraction length clamped, owner the rank whose slice holds the
        window's end, the start in this rank's stream decomposed for the
        front-end (tile * ALIGN + r + lead), the class split by
        lead-inflated length and bin, then each class's window of the
        members this rank owns (`BurstDecoder._route_windows`)."""
        p, ls, L = self.p, self.slice_len, self.l_ext
        rows = tables[:, 1:, :].long()
        start, stop = rows[..., 1], rows[..., 2]
        start_rel = torch.maximum(start, floor)
        ext_len = torch.clamp(stop + p.burst_pre_len - start_rel,
                              max=L - window_gather.ALIGN)
        owner = torch.clamp((start_rel + ext_len - 1) // ls, 0, self.n - 1)
        local_start = torch.clamp(start_rel - self.rank * ls + L, 0, L + ls)
        return self._route_windows(tables, local_start, ext_len, skips,
                                   keep=owner == self.rank)

    def _process(self, blk: _Block, skips) -> torch.Tensor:
        """One round of the process step for `blk` on this rank: the 1-D
        i32 buffer [head | class counts | metas | table rows | packed
        rows] (:466-469)."""
        skips = [int(s) for s in skips]
        scal = [max(-blk.base, -(2**31 - 1))] + skips
        head = blk.tables[0 if self.replicated else self.rank, 0]
        if self.device.type == "cpu":
            planes, tables = blk.planes, blk.tables
            scal_t, graph = torch.tensor(scal, dtype=torch.int64), None
        else:
            if self._graph is None:
                self._graph = pl.GroupGraph(self, self.stream_len,
                                            self.n_tables)
            graph = self._graph
            graph.load(blk.planes, blk.tables, scal)
            planes, tables, scal_t = graph.planes, graph.tables, graph.scal
        return torch.cat([head] + pl.class_program(
            self.classes, planes,
            lambda: self.route(tables, scal_t[0], scal_t[1:]), skips,
            graph))

    def _gather_results(self, bufs: list) -> tuple:
        """Every rank's process buffers of a round, (n, len(bufs), W) i32,
        copied to the host: (host tensor, event to wait on or None)."""
        g = self._all_gather(torch.stack(bufs)[None])
        if self.device.type == "cpu":
            return g, None
        host = torch.empty(g.shape, dtype=torch.int32, pin_memory=True)
        host.copy_(g, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _wait(self, res) -> np.ndarray:
        host, ev = res
        t0 = time.perf_counter()
        if ev is not None:
            ev.synchronize()
            self._drain_events()
        self.timing["result_fetch_wait"] += time.perf_counter() - t0
        return host.numpy()

    # ---- finish ----

    def _consume(self, buf: np.ndarray, blk: _Block, skips: np.ndarray,
                 frames: list, first: bool):
        """Frames from one round of one block, every rank's buffer (n, W)
        (`_consume_buf` :670-742). Returns (new skips, done)."""
        pre, n = self.p.burst_pre_len, self.n
        ls, L = self.slice_len, self.l_ext
        base = blk.base
        if first:
            self._count_rank_heads(buf[:, :6])

        def locate(meta, rows):
            # the owner's stream position, as the routing found it
            # (:722-737)
            start_rel = np.maximum(rows[1], -base)
            ext_len = np.minimum(rows[2] + pre - start_rel,
                                 L - window_gather.ALIGN)
            owner = np.clip((start_rel + ext_len - 1) // ls, 0, n - 1)
            return (start_rel + base,
                    np.clip(start_rel - owner * ls + L, 0, L + ls))

        found, skips, done = self._parse_round(buf[:, 6:], skips, locate)
        frames += [f for _, f in found]
        return skips, done

    def _count_rank_heads(self, heads: np.ndarray) -> None:
        """Stats from one block's rank heads: the replicated heads are
        equal and count once; binshard's are the ranks' own bins and sum.
        The noise and peak columns are the last block's."""
        eff = heads[:1] if self.replicated else heads
        self._count_heads(eff[:, :4].astype(np.int64).sum(0, keepdims=True))
        f = np.ascontiguousarray(eff[:, 4:6]).view(np.float32)
        self._noise_sum = float(f[:, 0].astype(np.float64).sum())
        self._peak = float(f[:, 1].max())

    def _finish_group(self, blocks: list, res) -> list[list[dict]]:
        """Per-block frame lists of a group, each sorted by burst id; a
        block whose classes overflowed takes more rounds, on every rank."""
        buf_all = self._wait(res)
        self.timing["n_groups"] += 1
        out = []
        for i, blk in enumerate(blocks):
            t1 = time.perf_counter()
            frames: list[dict] = []
            skips, done = self._consume(buf_all[:, i], blk,
                                        np.zeros(3, np.int64), frames, True)
            self.timing["host_parse"] += time.perf_counter() - t1
            while not done:
                t0 = time.perf_counter()
                r = self._gather_results([self._process(blk, skips)])
                self.timing["group_dispatch"] += time.perf_counter() - t0
                buf = self._wait(r)[:, 0]
                self.timing["n_overflow_rounds"] += 1
                t1 = time.perf_counter()
                skips, done = self._consume(buf, blk, skips, frames, False)
                self.timing["host_parse"] += time.perf_counter() - t1
            frames.sort(key=lambda f: f["id"])
            out.append(frames)
        return out

    # ---- drivers ----

    def run_blocks(self, blocks) -> Iterator[list[dict]]:
        """`blocks` yields (samples, n_valid); yields each block's frames,
        in order, on every rank. Detect steps run as blocks arrive; every
        `agg_blocks` blocks make a group whose first round is dispatched at
        once and finished once more than DEPTH groups are in flight (as
        `Pipeline.run_blocks`). The finish is on the calling thread: every
        rank issues the same collectives in the same order."""
        fut: collections.deque = collections.deque()
        pend: list[_Block] = []

        def flush():
            t0 = time.perf_counter()
            zero = np.zeros(3, np.int64)
            res = self._gather_results([self._process(b, zero)
                                        for b in pend])
            self.timing["group_dispatch"] += time.perf_counter() - t0
            fut.append((list(pend), res))
            pend.clear()

        it = iter(blocks)
        while True:
            t0 = time.perf_counter()
            nxt = next(it, None)
            self.timing["read"] += time.perf_counter() - t0
            if nxt is None:
                break
            pend.append(self._dispatch_step(*nxt))
            if len(pend) >= self.agg_blocks:
                flush()
            self.stats.q_peak = max(self.stats.q_peak,
                                    len(fut) * self.agg_blocks + len(pend))
            while len(fut) > DEPTH:
                yield from self._finish_group(*fut.popleft())
        if pend:
            flush()
        while fut:
            yield from self._finish_group(*fut.popleft())

    def take_q_peak(self) -> int:
        v, self.stats.q_peak = self.stats.q_peak, 0
        return v

    def share_blocks(self, blocks) -> Iterator[tuple[torch.Tensor, int]]:
        """Rank 0's blocks on every rank, for a stream that only rank 0 can
        read (stdin). Rank 0 iterates `blocks` ((samples, n_valid) as
        `readers.read_blocks` yields them; the other ranks pass None) and
        broadcasts [n_valid, end] and then the block, a fresh
        (block_samples,) complex64 tensor on the device each time; every
        rank yields (block, n_valid) and stops after the same block, when
        rank 0's blocks end (an empty stream: at once). Feed the result to
        `run_blocks`."""
        it = iter(blocks) if self.rank == 0 else None
        head = torch.zeros(2, dtype=torch.int64, device=self.device)
        while True:
            nxt = next(it, None) if it is not None else None
            if it is not None:
                head.copy_(torch.tensor([0, 1] if nxt is None
                                        else [int(nxt[1]), 0]))
            self._coll(dist.broadcast, head, 0, self.mesh.group)
            n_valid, end = head.tolist()
            if end:
                return
            block = torch.empty(self.p.block_samples, dtype=torch.complex64,
                                device=self.device)
            if nxt is not None:
                block.copy_(torch.as_tensor(nxt[0]))
            self._coll(dist.broadcast, torch.view_as_real(block), 0,
                       self.mesh.group)
            yield block, n_valid

    def run_file(self, path: str, fmt: str | None = None) -> Iterator[dict]:
        """Frames of a capture file, which every rank reads (the native
        reader); rank 0 yields them."""
        emit = self.rank == 0
        for frames in self.run_blocks(native.read_blocks(
                path, self.p.block_samples, fmt, self.device)):
            if emit:
                yield from frames

    def run_array(self, samples: np.ndarray) -> Iterator[dict]:
        """Frames of a capture in memory, which every rank holds; rank 0
        yields them."""
        emit = self.rank == 0
        for frames in self.run_blocks(self._array_blocks(samples)):
            if emit:
                yield from frames

    def noise_floor_db(self) -> float:
        """Average noise floor in dBFS/Hz over every rank's owned bins
        (:870-888), as of the last block finished."""
        return self._noise_db(self._noise_sum)

    def peak_signal_db(self) -> float:
        """The strongest detection over the ranks, as of the last block
        finished."""
        return self._peak
