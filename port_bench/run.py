"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``port_bench/``
and the port, ``contrast_renderer_tpu_torch/``, on a machine with a CUDA
card.  The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` the
per-layer metrics and ``breakdown``, and last ``checks``); the last
lines of standard error are the numbers compared, each beside its limit.
Without a card, or with fewer cards than the cell asks for, it exits 2
and prints no result.

``--readings --seeds 1,2,3`` measures the comparison's readings instead,
with one set-up for many seeds: each seed's window (``--seconds``), the
off share of each frame kept, and the control's (the reference computed
in bfloat16) on the same frames, one JSON line a seed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# Every build and kernel cache stays inside the checkout, at fixed paths.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, str(ROOT / ".bench_cache" / sub))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--readings", action="store_true")
    p.add_argument("--seeds", default="")
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import torch

    from port_bench.harness import cell as cell_mod
    from port_bench.harness import check

    cell = cell_mod.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.readings:
        from port_bench.harness import readings

        return readings.many(cell, [int(s) for s in args.seeds.split(",") if s],
                             args.seconds, T0)
    result, run = cell_mod.run_once(args.workload, args.seed, args.seconds,
                                    bool(args.trace), T0)
    print(cell_mod.window_line(run), file=sys.stderr)
    loaded = cell_mod.forbidden_modules(sys.modules)
    if loaded:
        print(f"port_bench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for line in check.lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
