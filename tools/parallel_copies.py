"""Run several copies of one test file at once, as the suite's xdist
workers run files side by side, and time each copy.

    python3 tools/parallel_copies.py tests/test_torch_scheduler.py
    python3 tools/parallel_copies.py tests/test_torch_scheduler.py \\
        --copies 6 --torch-threads 1 --root DIR --env OMP_NUM_THREADS=1

from the repository root. Starts ``--copies`` processes together, each
``python -m pytest -q -p no:cacheprovider -p no:randomly FILE`` from
``--root`` (a checkout, this one by default, with ``PYTHONPATH=src`` and
``JAX_PLATFORMS=cpu``), waits for all, and prints one line a copy (its
wall seconds and pytest's last line), then the wall of the whole set.
``--torch-threads N`` calls ``torch.set_num_threads(N)`` in each process
before pytest starts, as a test file that sets it at import would;
``--env NAME=VALUE`` adds to each process's environment. CPU only: it
measures how the copies share the machine's cores.
"""
import argparse
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("file")
    ap.add_argument("--copies", type=int, default=6)
    ap.add_argument("--torch-threads", type=int, default=None)
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--env", action="append", default=[])
    args = ap.parse_args()
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.update(kv.split("=", 1) for kv in args.env)
    pre = ("" if args.torch_threads is None else
           f"import torch; torch.set_num_threads({args.torch_threads}); ")
    code = (pre + "import sys, pytest; sys.exit(pytest.main(['-q', '-p', "
            f"'no:cacheprovider', '-p', 'no:randomly', {args.file!r}]))")

    def run(i, results):
        start = time.perf_counter()
        p = subprocess.run([sys.executable, "-c", code], cwd=args.root,
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
        results[i] = (time.perf_counter() - start, p.returncode, last)

    t0 = time.perf_counter()
    results = {}
    workers = [threading.Thread(target=run, args=(i, results))
               for i in range(args.copies)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    rc = 0
    for i in range(args.copies):
        wall, code_i, last = results[i]
        print(f"copy {i}: {wall:.1f} s wall, rc {code_i}: {last}",
              flush=True)
        rc = rc or code_i
    print(f"all {args.copies} copies: {time.perf_counter() - t0:.1f} s "
          f"wall (torch threads {args.torch_threads or 'default'}, env "
          f"{args.env or 'unchanged'})", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
