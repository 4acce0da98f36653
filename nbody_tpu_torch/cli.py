"""Command-line front end: one entry point for the reference's program
generations, on the GPU (or, with --device cpu, the plain versions on
the CPU).

  python -m nbody_tpu_torch run    --preset v5_bench --steps 1000      # nbody_v5_bench
  python -m nbody_tpu_torch run    --preset simple --method direct     # nbody_simple
  python -m nbody_tpu_torch run    --preset bh_legacy --steps 100 --dump out.txt   # nbody_bh
  python -m nbody_tpu_torch render --preset v5 --steps 100 --out frames/           # nbody_v5
  python -m nbody_tpu_torch view   --preset v5 --port 8089                         # nbody_v5 window
  python -m nbody_tpu_torch bench  --n 1000000 --frames 100            # bench table
  python -m nbody_tpu_torch info
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from nbody_tpu_torch.config import SimConfig, PRESETS


def _add_common(p):
    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--theta", type=float, default=None)
    p.add_argument("--dt", type=float, default=None)
    p.add_argument("--g", type=float, default=None)
    p.add_argument("--softening", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--method", choices=["barnes_hut", "barnes_hut_reference",
                                        "direct"], default="barnes_hut")
    p.add_argument("--no-pallas", action="store_true",
                   help="the plain PyTorch force sweeps, not the CUDA kernels")
    p.add_argument("--ic", choices=["disk_galaxy", "legacy_disk",
                                    "uniform_cube"], default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, which fails without "
                        "a GPU); cpu runs the plain versions")


def _cfg_from_args(args) -> SimConfig:
    cfg = PRESETS[args.preset] if args.preset else SimConfig()
    over = {}
    for k in ("n", "theta", "dt", "g", "softening", "seed"):
        v = getattr(args, k, None)
        if v is not None:
            over[k] = v
    if args.ic:
        over["ic_kind"] = args.ic
    if args.no_pallas:
        over["use_pallas"] = False
    return cfg.replace(**over) if over else cfg


def _sim(args):
    from nbody_tpu_torch.models.simulation import Simulation

    cfg = _cfg_from_args(args)
    return cfg, Simulation(cfg, method=args.method, device=args.device)


def _report_launches(device) -> None:
    """The hand kernels' launch counts of this process, on stderr."""
    if device.type == "cuda":
        from nbody_tpu_torch.ops.cuda import forces as kern

        print(f"kernel launches: {json.dumps(kern.LAUNCHES)}",
              file=sys.stderr)


def cmd_run(args) -> int:
    from nbody_tpu_torch.utils import io, metrics
    from nbody_tpu_torch.utils.profiling import _sync

    cfg, sim = _sim(args)
    state = sim.init_state()
    t0 = time.perf_counter()
    state = sim.step(state)
    _sync(state)
    print(f"compile+step0: {time.perf_counter()-t0:.2f}s", file=sys.stderr)

    # "Step %4d/%d | Time | ... | Nodes: %d" telemetry of the legacy
    # binaries (strings in nbody_bh.exe)
    every = args.log_every or max(args.steps // 10, 1)
    show_cells = bool(args.log_every) and args.method.startswith("barnes_hut")
    last_t = [time.perf_counter()]

    def report(i, s):
        now = time.perf_counter()
        ms = (now - last_t[0]) * 1e3 / every
        last_t[0] = now
        ke = metrics.kinetic_energy(s)
        line = (f"Step {i:4d}/{args.steps} | Time: {ms:8.2f} ms | "
                f"KE: {float(ke):.4e}")
        if show_cells:
            line += f" | Cells: {int(metrics.cell_count(s, cfg))}"
        print(line)

    state = sim.run(state, args.steps - 1, callback=report,
                    callback_every=every)
    _sync(state)
    summ = metrics.summary(state, cfg, with_pe=(cfg.n <= 200_000))
    if args.method.startswith("barnes_hut") and args.diagnostics:
        summ["structure"] = metrics.bh_diagnostics(state, cfg)
    print(json.dumps(summ, indent=2))
    if args.dump:
        io.dump_state_text(args.dump, state, cfg, args.steps)
        print(f"wrote {args.dump}")
    if args.checkpoint:
        io.save_checkpoint(args.checkpoint, state, args.steps)
        print(f"wrote {args.checkpoint}")
    _report_launches(sim.device)
    return 0


def cmd_bench(args) -> int:
    from nbody_tpu_torch.utils.profiling import (_sync, frame_table,
                                                 phase_times)

    cfg, sim = _sim(args)
    state = sim.init_state()
    state = sim.step(state)                 # warm-up (and the kernel build)
    _sync(state)
    if args.trace:
        from nbody_tpu_torch.utils.profiling import trace

        with trace(args.trace):
            state = sim.step(state)
            _sync(state)
        print(f"profiler trace written to {args.trace}")
    rows = frame_table(sim.step, state, args.frames)
    ms = sorted(r["ms"] for r in rows)
    med = ms[len(ms) // 2]
    print(f"\nmedian {med:.3f} ms/step  ({1000.0/med:.1f} steps/s)")
    if args.phases:
        print(json.dumps(phase_times(state, cfg), indent=2))
    if args.transfers:
        from nbody_tpu_torch.utils.profiling import transfer_bench

        print(json.dumps(transfer_bench(device=sim.device), indent=2))
    _report_launches(sim.device)
    return 0


def cmd_render(args) -> int:
    from nbody_tpu_torch.utils.profiling import _sync
    from nbody_tpu_torch.viz.render import render_state, write_ppm

    cfg, sim = _sim(args)
    state = sim.init_state()
    os.makedirs(args.out, exist_ok=True)
    for i in range(args.steps):
        state = sim.step(state)
        if i % args.every == 0:
            frame = render_state(state, cfg, mode=args.mode,
                                 exposure=args.exposure)
            path = os.path.join(args.out, f"frame_{i:05d}.ppm")
            write_ppm(path, frame)
            print(f"{path}")
    _sync(state)
    return 0


def cmd_view(args) -> int:
    """Live interactive viewer: the nbody_v5 window's counterpart
    (nbody_v5.cu:327-356 display loop, :459-473 mouse callbacks), served
    over HTTP."""
    from nbody_tpu_torch.utils.profiling import _sync
    from nbody_tpu_torch.viz.viewer import SimViewer, serve

    cfg, sim = _sim(args)
    state = sim.init_state()
    t0 = time.perf_counter()
    state = sim.step(state)
    _sync(state)
    print(f"compile+step0: {time.perf_counter()-t0:.2f}s", file=sys.stderr)
    viewer = SimViewer(sim, state, cfg, mode=args.mode, exposure=args.exposure,
                       steps_per_frame=args.steps_per_frame)
    viewer.start()
    server = serve(viewer, port=args.port, host=args.host)
    print(f"viewing {cfg.n} bodies at http://{args.host}:{args.port}/  "
          f"(ssh -L {args.port}:localhost:{args.port} if remote; Ctrl-C stops)")
    try:
        while viewer.error is None:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        viewer.stop()
    return 0


def cmd_info(args) -> int:
    import torch

    from nbody_tpu_torch.native import runtime
    from nbody_tpu_torch.ops.cuda import build

    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"  device: cpu")
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        print(f"  device: cuda:{i} {p.name} sm_{p.major}{p.minor} "
              f"{p.total_memory / 2**30:.1f} GiB")
    print(f"native runtime: {runtime.status()}")
    for name in build.LIBRARIES:
        path = build.library_path(name)
        print(f"kernel library {name}: "
              f"{'built ' + str(path) if path.exists() else 'not built'}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbody_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="headless simulation "
                           "(nbody_simple/bh/v5_bench workloads)")
    _add_common(p_run)
    p_run.add_argument("--dump", default=None,
                       help="write legacy-format text dump")
    p_run.add_argument("--checkpoint", default=None,
                       help="write npz checkpoint")
    p_run.add_argument("--diagnostics", action="store_true",
                       help="report cell/band telemetry "
                            "(legacy 'Nodes: %%d' parity)")
    p_run.add_argument("--log-every", type=int, default=0, metavar="K",
                       help="print Step|ms|KE|Cells every K steps "
                            "(legacy 'Step %%4d/%%d | Time | Nodes' parity)")
    p_run.set_defaults(fn=cmd_run)

    p_b = sub.add_parser("bench",
                         help="Frame|ms|FPS table (nbody_v5_bench parity)")
    _add_common(p_b)
    p_b.add_argument("--frames", type=int, default=100)
    p_b.add_argument("--phases", action="store_true",
                     help="per-phase breakdown")
    p_b.add_argument("--transfers", action="store_true",
                     help="host<->device bandwidth (README.md:27 parity)")
    p_b.add_argument("--trace", default=None, metavar="DIR",
                     help="write a torch.profiler Chrome trace to DIR")
    p_b.set_defaults(fn=cmd_bench)

    p_r = sub.add_parser("render",
                         help="render frames to PPM (nbody_v5 visual parity)")
    _add_common(p_r)
    p_r.add_argument("--out", default="frames")
    p_r.add_argument("--every", type=int, default=1)
    p_r.add_argument("--mode", choices=["add", "depth"], default="add")
    p_r.add_argument("--exposure", type=float, default=1.0)
    p_r.set_defaults(fn=cmd_render)

    p_v = sub.add_parser("view", help="live interactive viewer "
                         "(nbody_v5 window parity)")
    _add_common(p_v)
    p_v.add_argument("--port", type=int, default=8089)
    p_v.add_argument("--host", default="127.0.0.1")
    p_v.add_argument("--mode", choices=["add", "depth"], default="add")
    p_v.add_argument("--exposure", type=float, default=1.0)
    p_v.add_argument("--steps-per-frame", type=int, default=1,
                     help="sim steps per rendered frame")
    p_v.set_defaults(fn=cmd_view)

    p_i = sub.add_parser("info", help="devices, native runtime and kernel "
                         "library status")
    p_i.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
