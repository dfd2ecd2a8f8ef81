"""hopperrender-tpu-torch command line: the PyTorch port of hopperrender_tpu/cli.py.

The same commands, arguments, outputs and exit codes, plus --device on
interpolate and serve: "cuda" (the default) runs the hand-written kernels and
exits 1 with the FrameServer's error when no CUDA device is present; "cpu"
runs their plain PyTorch versions. probe and settings touch no device.

Commands:
  interpolate  — offline file mode: read NV12/P010/Y4M (or any container via
                 ffmpeg when present), interpolate to the target fps, write the
                 result. The offline analogue of playing a file through the filter.
  serve        — live streaming mode: the threaded pipeline (decode thread ->
                 native frame rings -> engine thread -> output ring) with an
                 optional live HTTP status/control endpoint — the CLI equivalent
                 of the reference sitting in a running playback graph with its
                 property page open (ref: HopperRender.cpp:529-541,1466-1607).
                 Pipe-friendly: `ffmpeg ... -f yuv4mpegpipe - | hopperrender
                 serve - - --status-port 8080 | mpv -`.
  probe        — report stream parameters and the per-frame device latency budget.
  settings     — show / set / reset persisted settings (registry equivalent,
                 ref: HopperRender.cpp:1466-1607).

Run as `python -m hopperrender_tpu_torch <command> ...`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from hopperrender_tpu_torch import config
from hopperrender_tpu_torch.config import Settings, default_settings_path
from hopperrender_tpu_torch.utils import trace
from hopperrender_tpu_torch.utils.logging import get_logger

log = get_logger("cli")


def _add_io_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("input", help="input video (.y4m, .nv12/.p010/.yuv raw, any"
                   " container with ffmpeg, or '-' for a stdin pipe: y4m, or"
                   " raw when --width/--height are given)")
    p.add_argument("output", help="output video (.y4m, .nv12/.p010/.yuv raw,"
                   " any container with ffmpeg, or '-' for y4m on stdout)")
    p.add_argument("--width", type=int, help="frame width (raw input only)")
    p.add_argument("--height", type=int, help="frame height (raw input only)")
    p.add_argument("--fps", type=float, help="source fps (raw input; default 24)")
    p.add_argument("--hdr", action="store_true", help="10-bit P010 input")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine: cuda (the hand-written kernels; "
                        "fails without a CUDA device) or cpu (their plain versions)")


def _build_settings(args: argparse.Namespace) -> Settings:
    settings = Settings.load(args.settings) if args.settings else Settings()
    return dataclasses.replace(
        settings,
        target_fps=args.target_fps,
        use_display_fps=False,
        frame_output=args.mode,
        scene_change_threshold=args.scene_threshold
        if args.scene_threshold is not None else settings.scene_change_threshold,
    ).validate()


def cmd_interpolate(args: argparse.Namespace) -> int:
    from hopperrender_tpu_torch.server.frame_server import FrameServer
    from hopperrender_tpu_torch.vio import video

    reader = video.open_reader(args.input, width=args.width, height=args.height,
                               is_hdr=args.hdr, fps=args.fps)
    is_hdr = getattr(reader, "is_hdr", args.hdr)
    source_fps = args.fps or getattr(reader, "fps", 24.0)
    settings = _build_settings(args)

    server = FrameServer(reader.width, reader.height, source_fps=source_fps,
                         is_hdr=is_hdr, settings=settings, device=args.device)
    writer = video.open_writer(args.output, reader.width, reader.height,
                               args.target_fps, is_hdr=is_hdr)

    n_in = n_out = 0
    trace.enable(args.stats, keep=False)
    t0 = time.perf_counter()
    try:
        for y, uv in reader:
            n_in += 1
            for out in server.push_frame(y, uv):
                writer.write(out.y, out.uv)
                n_out += 1
            if args.max_frames and n_in >= args.max_frames:
                break
    finally:
        writer.close()
        trace.enable(False)
    wall = time.perf_counter() - t0
    m = server.metrics()
    log.info(
        "%d source -> %d output frames in %.2fs (%.1f out fps); "
        "flow %.2f ms (avg %.2f, peak %.2f), warp %.2f ms, radius %d",
        n_in, n_out, wall, n_out / wall if wall else 0.0,
        m.ofc_calc_time * 1e3, m.avg_ofc_calc_time * 1e3, m.peak_ofc_calc_time * 1e3,
        m.warp_calc_time * 1e3, m.search_radius,
    )
    if args.stats:
        # stdout carries the video stream when output is '-'; stats must not
        # corrupt it.
        print(json.dumps({
            "frames_in": n_in, "frames_out": n_out, "wall_s": round(wall, 3),
            "out_fps": round(n_out / wall, 2) if wall else 0.0,
            "metrics": dataclasses.asdict(m), **trace.per_frame(),
        }), file=sys.stderr if args.output == "-" else sys.stdout)
    return 0


def cmd_serve(args: argparse.Namespace) -> int:
    """Live streaming mode: decode, engine, and output run on separate threads
    over the native frame rings; an optional HTTP endpoint exposes live metrics
    (GET /metrics, /settings, /healthz) and live control (POST /settings) while
    the stream runs — the reference's property page + TooSlow watchdog
    equivalents (ref: HopperRender.cpp:1438-1463,1466-1607)."""
    import threading

    from hopperrender_tpu_torch.server.frame_server import FrameServer
    from hopperrender_tpu_torch.server.pipeline import PipelinedServer
    from hopperrender_tpu_torch.vio import video

    reader = video.open_reader(args.input, width=args.width, height=args.height,
                               is_hdr=args.hdr, fps=args.fps)
    is_hdr = getattr(reader, "is_hdr", args.hdr)
    source_fps = args.fps or getattr(reader, "fps", 24.0)
    settings = _build_settings(args)

    server = FrameServer(reader.width, reader.height, source_fps=source_fps,
                         is_hdr=is_hdr, settings=settings, device=args.device)
    writer = video.open_writer(args.output, reader.width, reader.height,
                               args.target_fps, is_hdr=is_hdr)
    pipe = PipelinedServer(server)
    status = None
    if args.status_port is not None:
        from hopperrender_tpu_torch.server.status_http import StatusServer

        status = StatusServer(server, port=args.status_port, pipeline=pipe)
        print(f"status endpoint: http://{status.host}:{status.port}/metrics",
              file=sys.stderr, flush=True)

    feed_err: list[BaseException] = []

    def feeder() -> None:
        try:
            n = 0
            for y, uv in reader:
                pipe.feed(y, uv)
                n += 1
                if args.max_frames and n >= args.max_frames:
                    break
        except BaseException as e:  # noqa: BLE001 - re-raised on the main thread
            feed_err.append(e)
        finally:
            pipe.close()

    th = threading.Thread(target=feeder, name="hrt-feed", daemon=True)
    n_out = 0
    trace.enable(args.stats, keep=False)
    t0 = time.perf_counter()
    th.start()
    try:
        for out in pipe.outputs():
            writer.write(out.y, out.uv)
            n_out += 1
    finally:
        writer.close()
        th.join(timeout=30)
        pipe.join()
        trace.enable(False)
        if status is not None:
            status.close()
    if feed_err:
        raise feed_err[0]
    wall = time.perf_counter() - t0
    m = server.metrics()
    log.info(
        "served %d source -> %d output frames in %.2fs (%.1f out fps); "
        "flow %.2f ms, warp %.2f ms, radius %d; input ring high water %d",
        pipe.stats.frames_in, n_out, wall, n_out / wall if wall else 0.0,
        m.ofc_calc_time * 1e3, m.warp_calc_time * 1e3, m.search_radius,
        pipe.stats.input_ring_high_water,
    )
    if args.stats:
        print(json.dumps({
            "frames_in": pipe.stats.frames_in, "frames_out": n_out,
            "wall_s": round(wall, 3),
            "out_fps": round(n_out / wall, 2) if wall else 0.0,
            "renegotiations": pipe.stats.renegotiations,
            "input_ring_high_water": pipe.stats.input_ring_high_water,
            "metrics": dataclasses.asdict(m), **trace.per_frame(),
        }), file=sys.stderr if args.output == "-" else sys.stdout)
    return 0


def cmd_probe(args: argparse.Namespace) -> int:
    from hopperrender_tpu_torch.vio import video

    reader = video.open_reader(args.input, width=args.width, height=args.height,
                               is_hdr=args.hdr, fps=args.fps)
    rs, low_h, low_w = config.calc_flow_dims(reader.height, reader.width,
                                             config.MAX_CALC_RES)
    fps = args.fps or getattr(reader, "fps", 24.0)
    print(json.dumps({
        "width": reader.width, "height": reader.height,
        "is_hdr": getattr(reader, "is_hdr", args.hdr), "fps": fps,
        "flow_resolution": [low_w, low_h], "resolution_scalar": rs,
        "realtime_budget_ms": round(1e3 / fps, 3),
    }, indent=2))
    return 0


def cmd_settings(args: argparse.Namespace) -> int:
    path = args.file or default_settings_path()
    if args.reset:
        st = Settings()
    else:
        st = Settings.load(path)
    changed = False
    for kv in args.set or []:
        key, _, value = kv.partition("=")
        field_types = {f.name: f.type for f in dataclasses.fields(Settings)}
        if key not in field_types:
            print(f"unknown setting: {key}", file=sys.stderr)
            return 2
        current = getattr(st, key)
        if isinstance(current, bool):
            parsed = value.lower() in ("1", "true", "yes", "on")
        elif isinstance(current, int):
            parsed = int(value)
        else:
            parsed = type(current)(value)
        st = dataclasses.replace(st, **{key: parsed})
        changed = True
    st.validate()
    if changed or args.reset:
        import os

        os.makedirs(os.path.dirname(path), exist_ok=True)
        st.save(path)
    print(json.dumps(dataclasses.asdict(st), indent=2))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="hopperrender-tpu-torch")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("interpolate", help="interpolate a video file to a target fps")
    _add_io_args(p)
    p.add_argument("--target-fps", type=float, default=60.0)
    p.add_argument("--mode", type=int, default=2,
                   help="0 warp12, 1 warp21, 2 blend, 3 HSV flow, 4 grey flow, "
                        "5 side-by-side, 6 scaled side-by-side")
    p.add_argument("--scene-threshold", type=int, default=None)
    p.add_argument("--settings", help="settings JSON (default: none)")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--stats", action="store_true", help="print a JSON stats line")
    p.set_defaults(func=cmd_interpolate)

    p = sub.add_parser("serve", help="live streaming mode: threaded pipeline "
                       "+ optional HTTP status/control endpoint")
    _add_io_args(p)
    p.add_argument("--target-fps", type=float, default=60.0)
    p.add_argument("--mode", type=int, default=2,
                   help="0 warp12, 1 warp21, 2 blend, 3 HSV flow, 4 grey flow, "
                        "5 side-by-side, 6 scaled side-by-side")
    p.add_argument("--scene-threshold", type=int, default=None)
    p.add_argument("--settings", help="settings JSON (default: none)")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--stats", action="store_true", help="print a JSON stats line")
    p.add_argument("--status-port", type=int, default=None,
                   help="start the live HTTP status/control endpoint on this "
                        "port (0 = pick a free port; URL printed to stderr)")
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser("probe", help="report stream parameters")
    p.add_argument("input")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--fps", type=float)
    p.add_argument("--hdr", action="store_true")
    p.set_defaults(func=cmd_probe)

    p = sub.add_parser("settings", help="show/set persisted settings")
    p.add_argument("--file", help=f"settings path (default {default_settings_path()})")
    p.add_argument("--set", action="append", metavar="KEY=VALUE")
    p.add_argument("--reset", action="store_true")
    p.set_defaults(func=cmd_settings)

    args = ap.parse_args(argv)
    try:
        return args.func(args)
    except (FileNotFoundError, ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
