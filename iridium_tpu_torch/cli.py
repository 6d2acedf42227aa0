"""Command-line interface of the port: offline decode of a capture file to
`RAW:` lines on stdout, with the JAX package's flags (iridium_tpu/cli.py)
plus `--device`, and its protocol decoders: `--parsed` `IDA:` lines,
GSMTAP, ZMQ, ACARS text/JSON/UDP/feed, the diagnostic display, Doppler
positioning and the live web map.

    iridium-tpu-torch -f capture.cf32                    # on the GPU
    iridium-tpu-torch -f capture.cf32 --parsed --device cpu

The decoders are host code (numpy); their LLRs come off the card with the
packed rows only when a decoder is on. `--agg-blocks` sets the blocks that
share one group program and one result copy (4 for a file, 1 for stdin),
`--save-bursts` dumps each burst's samples (the per-batch flow), and
`--profile` writes a torch.profiler trace and prints the per-stage times.
`--mesh N` decodes through the sharded pipeline (parallel/stream.py,
replicated detect) over N ranks, one card each (gloo ranks with `--device
cpu`): under torchrun it joins the launcher's group, which must have N
ranks; otherwise it starts N local ranks (`distributed.spawn`). Every rank
reads the file; with `-f -` rank 0 alone reads stdin and broadcasts each
block to the others. Rank 0 alone prints lines, runs the decoders and
sockets and prints the stats line. The JAX package's backend switches
(`--no-pallas`, `--fir`, `--gather`, `--scan`) have no counterpart: the
card's path always runs the port's kernels.

Stats line: the gr-iridium-format 1 Hz stderr line (main.c:483-501).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

from .config import DetectorConfig, DownmixConfig
from .decode import batch as batch_mod
from .decode import ida as ida_mod
from .output.raw import RawPrinter


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="iridium-tpu-torch",
        description="Iridium burst detector and demodulator on a GPU "
                    "(PyTorch/CUDA). Outputs iridium-toolkit compatible "
                    "RAW format to stdout.")
    p.add_argument("-f", "--file", help="read IQ samples from file "
                   "('-' for stdin)")
    p.add_argument("--format", choices=("ci8", "ci16", "cf32"),
                   help="IQ file format (default: by extension, else ci8)")
    p.add_argument("-c", "--center-freq", type=float, default=1_622_000_000,
                   help="center frequency in Hz (default: 1622000000)")
    p.add_argument("-r", "--sample-rate", type=int, default=10_000_000,
                   help="sample rate in Hz (default: 10000000)")
    p.add_argument("-d", "--threshold", type=float, default=16.0,
                   help="burst detection threshold in dB (default: 16.0)")
    p.add_argument("--file-info", default=None,
                   help="file info string for output (default: auto)")
    p.add_argument("--no-gardner", action="store_true",
                   help="disable Gardner timing recovery")
    p.add_argument("--parsed", action="store_true",
                   help="output parsed IDA lines")
    p.add_argument("--diagnostic", action="store_true",
                   help="setup verification mode (suppresses RAW output)")
    p.add_argument("--gsmtap", nargs="?", const="127.0.0.1:4729",
                   metavar="HOST:PORT",
                   help="send IDA frames as GSMTAP via UDP")
    p.add_argument("--zmq", nargs="?", const="tcp://*:7006",
                   metavar="ENDPOINT",
                   help="publish output via ZMQ PUB socket")
    p.add_argument("--web", nargs="?", const=8888, type=int, metavar="PORT",
                   help="enable live web map")
    p.add_argument("--position", nargs="?", const=-1.0, type=float,
                   metavar="HEIGHT_M",
                   help="estimate receiver position from Doppler shift "
                        "(optional height aiding in meters)")
    p.add_argument("--acars", action="store_true",
                   help="decode and display ACARS messages from IDA")
    p.add_argument("--acars-json", action="store_true",
                   help="output ACARS as JSON")
    p.add_argument("--acars-udp", action="append", default=[],
                   metavar="HOST:PORT", help="stream ACARS JSON via UDP")
    p.add_argument("--feed", nargs="?",
                   const="tcp://feed.airframes.io:5590",
                   metavar="PROTO://HOST:PORT",
                   help="feed aggregator (udp:// for acarshub, tcp:// "
                        "for airframes.io)")
    p.add_argument("--station", default="IRIDIUM-TPU",
                   help="station identifier for ACARS JSON output")
    p.add_argument("--save-bursts", metavar="DIR",
                   help="save IQ samples of decoded bursts to directory")
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler trace (Chrome/Perfetto "
                        "JSON) of the run into DIR and print the "
                        "per-stage timing breakdown")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="accepted for compatibility with iridium-tpu")
    p.add_argument("--burst-batch", type=int, default=128,
                   help="device burst batch size")
    p.add_argument("--frames-per-block", type=int, default=512,
                   help="FFT frames per device block")
    p.add_argument("--agg-blocks", type=int, default=None,
                   help="blocks per group program and result copy "
                        "(default 4 for a file, 1 for stdin to keep the "
                        "output latency at one block)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device; "
                        "'cpu' runs the plain versions of the kernels)")
    p.add_argument("--mesh", type=int, metavar="N",
                   help="run the capture through the sharded pipeline over "
                        "N ranks, one card each (gloo ranks on the CPU with "
                        "--device cpu); under torchrun the launcher's N "
                        "ranks, else N local processes; output is printed "
                        "by rank 0 only")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.file:
        print("error: -f/--file required", file=sys.stderr)
        return 2
    # live mode (stdin): one block a group, to keep the output latency at
    # one block, and the first stats column reads i:/s (main.c:487-492)
    live = args.file in ("-", "/dev/stdin")
    if args.mesh is not None:
        from .parallel import distributed
        if not distributed.in_group():
            return _spawn_mesh(args, sys.argv[1:] if argv is None else argv)
    from .io import native
    from .runtime.pipeline import Pipeline   # deferred: imports torch

    det = DetectorConfig(center_frequency=args.center_freq,
                         sample_rate=args.sample_rate,
                         threshold_db=args.threshold,
                         frames_per_block=args.frames_per_block)
    # LLRs cross the device->host boundary only when a protocol decoder
    # consumes them; the RAW line itself never prints them.
    decode_active = (args.parsed or args.gsmtap or args.web is not None
                     or args.position is not None or args.acars
                     or args.acars_json or args.acars_udp or args.feed)
    agg = args.agg_blocks or (1 if live else 4)
    made_group = False
    if args.mesh is not None:
        # a rank of the sharded pipeline (iridium_tpu/cli.py:150-175)
        from .parallel.stream import ShardedPipeline
        made_group = distributed.initialize(device=args.device)
        mesh = distributed.make_mesh()
        if mesh.n != args.mesh:
            print(f"error: --mesh {args.mesh} but the group has {mesh.n} "
                  "ranks", file=sys.stderr)
            if made_group:
                distributed.shutdown()
            return 2
        host0 = distributed.is_host0()
        if args.save_bursts and host0:
            print("warning: --save-bursts is not supported on the "
                  "--mesh sharded path; ignoring", file=sys.stderr)
        pipe = ShardedPipeline(det, DownmixConfig(), mesh=mesh,
                               burst_batch=args.burst_batch,
                               use_gardner=not args.no_gardner,
                               want_llr=bool(decode_active), agg_blocks=agg,
                               device=args.device)
    else:
        pipe = Pipeline(det_cfg=det, dm_cfg=DownmixConfig(),
                        burst_batch=args.burst_batch,
                        use_gardner=not args.no_gardner,
                        device=args.device, want_llr=bool(decode_active),
                        save_bursts_dir=args.save_bursts, agg_blocks=agg)
        host0 = True
    try:
        return _decode(args, pipe, native, live, host0)
    finally:
        if made_group:
            distributed.shutdown()


def _spawn_mesh(args, argv: list) -> int:
    """--mesh N outside a group: N local ranks, one card each, each running
    main(argv); the exit code is rank 0's (any rank's failure raises)."""
    import torch
    from . import device as device_mod
    from .parallel import distributed
    dev = device_mod.resolve(args.device)
    if dev.type == "cuda" and torch.cuda.device_count() < args.mesh:
        # the JAX CLI's message (iridium_tpu/cli.py:158-162)
        print(f"error: --mesh {args.mesh} but only "
              f"{torch.cuda.device_count()} devices available",
              file=sys.stderr)
        return 2
    return distributed.spawn(main, args.mesh, args.device, list(argv))[0]


def _blocks(args, pipe, native, live: bool):
    """The decode's (block, n_valid) pairs: a file through the native
    reader (into pinned buffers on the card), which on the mesh every rank
    runs; stdin through the Python reader. On the mesh, stdin is read by
    rank 0 alone, from fd 0: a rank that `distributed.spawn` started
    inherits the CLI process's fd 0 (multiprocessing replaces only
    `sys.stdin`, with /dev/null), and the CLI process itself reads
    nothing; under torchrun it is rank 0's own stdin. Rank 0 broadcasts
    each block and the stream's end to the others
    (`ShardedPipeline.share_blocks`)."""
    if not (live and args.mesh is not None):
        return native.read_blocks(args.file, pipe.p.block_samples,
                                  args.format, pipe.device)

    def stdin_blocks():
        from .io import readers
        with open(0, "rb", closefd=False) as f:
            yield from readers.read_stream(f, pipe.p.block_samples,
                                           args.format or "ci8")
    return pipe.share_blocks(stdin_blocks() if pipe.rank == 0 else None)


def _decode(args, pipe, native, live: bool, host0: bool) -> int:
    """The decode loop with its outputs; on a rank other than 0 (host0
    False) it only drives the pipeline: no lines, sockets or stats."""
    if not host0:
        for _ in pipe.run_blocks(_blocks(args, pipe, native, live)):
            pass
        return 0
    printer = RawPrinter(args.file_info)

    zmq_sock = None
    if args.zmq is not None:
        try:
            import zmq as zmq_mod
            ctx = zmq_mod.Context()
            zmq_sock = ctx.socket(zmq_mod.PUB)
            zmq_sock.bind(args.zmq.replace("*", "0.0.0.0")
                          if "*" in args.zmq else args.zmq)
        except ImportError:
            print("warning: pyzmq not available, --zmq disabled",
                  file=sys.stderr)

    gsmtap = None
    if args.gsmtap:
        from .output.gsmtap import GsmtapSender
        host, _, port = args.gsmtap.partition(":")
        gsmtap = GsmtapSender(host or "127.0.0.1", int(port or 4729))

    web = None
    if args.web is not None:
        from .output.web_map import WebMap
        web = WebMap(port=args.web)
        web.start()

    doppler = None
    if args.position is not None:
        from .decode.doppler import DopplerSolver
        doppler = DopplerSolver(
            height_aid_m=None if args.position < 0 else args.position)

    acars = None
    if args.acars or args.acars_json or args.acars_udp or args.feed:
        from .decode.sbd_acars import AcarsDecoder, FeedSender
        feed = FeedSender(args.feed) if args.feed else None
        acars = AcarsDecoder(json_out=args.acars_json,
                             udp_targets=args.acars_udp,
                             station=args.station,
                             feed_sender=feed)

    need_ida = (args.parsed or gsmtap is not None or acars is not None
                or web is not None)
    # Three independent reassembly contexts, like the reference's
    # ida_ctx / acars_ida_ctx / mtpos_ida_ctx (main.c:351-369): each
    # consumer sees every reassembled message exactly once.
    reasm_gsmtap = ida_mod.IdaReassembler() if gsmtap else None
    reasm_acars = ida_mod.IdaReassembler() if acars else None
    reasm_mtpos = ida_mod.IdaReassembler() if web is not None else None

    # any ACARS mode suppresses RAW stdout (reference frame_output.c:162,
    # options.c:403-431: --acars/--acars-json/--acars-udp/--feed all set
    # acars_enabled)
    acars_mode = acars is not None

    def emit(line: str) -> None:
        if not args.diagnostic and not acars_mode:
            print(line)
        if zmq_sock is not None:
            zmq_sock.send_string(line)

    t_start = last_stat = last_solve = last_waiting = time.time()
    prev = dict(det=0, ok=0, handled=0, samples=0)

    def stats_line() -> None:
        nonlocal last_stat, last_solve, last_waiting, prev
        now = time.time()
        dt = now - last_stat
        if dt < 1.0:
            return
        s = pipe.stats
        elapsed = now - t_start
        dd = s.n_detected - prev["det"]
        dk = s.n_ok - prev["ok"]
        dh = s.n_handled - prev["handled"]
        srr = (s.n_samples - prev["samples"]) / (args.sample_rate * dt) * 100
        in_ok = 100.0 * dk / dd if dd > 0 else 0
        ok_avg = 100.0 * s.n_ok / s.n_detected if s.n_detected else 0
        last_stat = now
        prev = dict(det=s.n_detected, ok=s.n_ok, handled=s.n_handled,
                    samples=s.n_samples)
        if args.diagnostic:
            # guided-setup display (reference main.c:444-481)
            rt = int(elapsed)
            bpm = s.n_detected * 60.0 / elapsed if elapsed > 0 else 0
            nf = pipe.noise_floor_db()
            pk = pipe.peak_signal_db()
            line = (f"Runtime: {rt // 3600:02d}:{rt % 3600 // 60:02d}:"
                    f"{rt % 60:02d}  |  Bursts: {s.n_detected} detected "
                    f"({bpm:.1f}/min)  |  Decoded: {s.n_ok} "
                    f"(ok_avg: {ok_avg:.0f}%)  |  Noise: {nf:.1f} dBFS/Hz"
                    f"  |  Peak: {pk:.1f} dB  ")
            if s.n_detected == 0 and elapsed > 120:
                line += "| No bursts detected - check antenna"
            elif ok_avg >= 70 and bpm >= 3:
                line += f"| Setup looks good (gap: {pk - nf:.1f} dB)"
            elif ok_avg < 70 and s.n_detected > 10:
                line += "| Low decode rate - try adjusting gain"
            elif ok_avg >= 70 and bpm < 3 and elapsed > 60:
                line += "| Good decode rate but low burst count"
            print(line, file=sys.stderr)
            return
        first = f"i: {dd / dt:3.0f}/s" if live else f"srr: {srr:5.1f}%"
        print(f"{int(now)} | {first}"
              f" | i_avg: {s.n_detected / elapsed:3.0f}/s"
              f" | q_max: {pipe.take_q_peak():4d}"
              f" | i_ok: {in_ok:3.0f}%"
              f" | o: {dh / dt:4.0f}/s"
              f" | ok: {in_ok:3.0f}%"
              f" | ok: {dk / dt:3.0f}/s"
              f" | ok_avg: {ok_avg:3.0f}%"
              f" | ok: {s.n_ok:10d}"
              f" | ok_avg: {s.n_ok / elapsed:3.0f}/s"
              f" | d: {s.n_dropped}", file=sys.stderr)
        # Doppler solve every ~10 s; "waiting" note every ~60 s while
        # unconverged (reference main.c:507-519)
        if doppler is not None and now - last_solve >= 10 and elapsed > 5:
            last_solve = now
            sol = doppler.solve()
            if sol.converged:
                print(f"POSITION: {sol.lat:.6f}, {sol.lon:.6f} "
                      f"(HDOP={sol.hdop:.1f}, {sol.n_satellites} sats, "
                      f"{sol.n_measurements} meas)", file=sys.stderr)
                if web is not None:
                    web.set_position(sol.lat, sol.lon, sol.hdop)
            elif now - last_waiting >= 60:
                last_waiting = now
                print(f"POSITION: waiting ({sol.n_satellites} sats, "
                      f"{sol.n_measurements} meas)", file=sys.stderr)

    n_gsmtap = 0
    need_frame = web is not None or doppler is not None

    def send_gsmtap(data, ts, freq, direction, mag):
        nonlocal n_gsmtap
        gsmtap.send(data, freq, direction, mag)
        n_gsmtap += 1

    with profiler(args.profile, pipe.device) as prof:
        for frames in pipe.run_blocks(_blocks(args, pipe, native, live)):
            # Block-vectorised protocol decode: one decode_block call covers
            # every frame's BCH/LCW/IDA math (frame_decode.c:414-598,
            # ida_decode.c:543-664).
            if need_ida or need_frame:
                results = batch_mod.decode_block(
                    frames, want_frame=need_frame, want_ida=need_ida)
            else:
                results = [(None, None)] * len(frames)
            for f, (decoded, ida_burst) in zip(frames, results):
                if args.parsed and ida_burst is not None:
                    emit(printer.format_ida(ida_burst))
                else:
                    emit(printer.format(f))

                if decoded is not None:
                    kind, d = decoded
                    if kind == "IRA":
                        if web is not None:
                            web.add_ra(d, f["timestamp_ns"], f["frequency"])
                        if doppler is not None:
                            doppler.add_measurement(d, f["frequency"],
                                                    f["timestamp_ns"])
                    elif kind == "IBC" and web is not None:
                        web.add_sat(d, f["timestamp_ns"])

                if gsmtap is not None and ida_burst is not None:
                    reasm_gsmtap.push(ida_burst, send_gsmtap)
                    reasm_gsmtap.flush(f["timestamp_ns"])
                if acars is not None and ida_burst is not None:
                    reasm_acars.push(ida_burst, acars.process)
                    reasm_acars.flush(f["timestamp_ns"])
                if reasm_mtpos is not None:
                    # MT position layer on the map (main.c:365-369 ->
                    # mtpos_ida_cb, web_map.c:280-361)
                    if ida_burst is not None:
                        reasm_mtpos.push(ida_burst, web.mtpos_ida_cb)
                    reasm_mtpos.flush(f["timestamp_ns"])
                stats_line()

    if prof is not None:
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        print_profile(pipe.timing, trace)

    # Shutdown summary prints unconditionally, like the reference
    # (burst_detect.c:350-351).
    print(f"burst_detect: tagged {pipe.stats.n_detected} bursts total",
          file=sys.stderr)
    if pipe.stats.n_em_dropped or pipe.stats.n_create_waits:
        print(f"burst_detect: {pipe.stats.n_em_dropped} emission-cap "
              f"drops, {pipe.stats.n_create_waits} deferred creations",
              file=sys.stderr)
    if gsmtap is not None:
        print(f"gsmtap: sent {n_gsmtap} frames", file=sys.stderr)
    if acars is not None:
        acars.print_stats()
    if web is not None:
        web.stop()
    if zmq_sock is not None:
        zmq_sock.close(linger=0)
    return 0


def profiler(trace_dir: str | None, device):
    """torch.profiler over the decode when `trace_dir` is given (the card's
    activity too on a CUDA device), else a context that does nothing."""
    if not trace_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def print_profile(t, trace: str) -> None:
    """The per-stage breakdown under the JAX package's keys
    (iridium_tpu/cli.py:393-407): cumulative host wall seconds."""
    nb = max(t["n_blocks"], 1)
    print("profile: per-stage cumulative wall seconds "
          "(ratios localize the bottleneck):", file=sys.stderr)
    for k in ("read", "step_dispatch", "group_dispatch",
              "result_fetch_wait", "host_parse", "host_format"):
        print(f"profile:   {k:<18} {t[k]:8.3f} s "
              f"({t[k] / nb * 1e3:7.2f} ms/block)", file=sys.stderr)
    print(f"profile:   blocks={t['n_blocks']} groups={t['n_groups']} "
          f"overflow_rounds={t['n_overflow_rounds']}; "
          f"trace written to {trace}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
