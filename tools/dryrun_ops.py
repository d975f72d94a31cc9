"""The bytes one dry-run cell meters (``bytes_accessed``), op by op.

    PYTHONPATH=src python3 tools/dryrun_ops.py --arch mistral_nemo_12b \\
        --shape decode_32k [--multi-pod] [--top 5]

Traces the cell as ``python -m repro_torch.launch.dryrun`` does (its
settings, a fake process group of 256 or 512 ranks, fake tensors; no
device), with each op's metered bytes (``dryrun._op_bytes``) tallied by
op overload, and prints one JSON line: the cell's ``bytes_accessed``,
the tally's total (the same number) and the ``--top`` ops by bytes with
their share. Runs on the CPU, one cell a process.
"""
import argparse
import collections
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.launch import dryrun  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=5)
    args = ap.parse_args(argv)
    by_op = collections.Counter()
    metered = dryrun._op_bytes

    def tallied(func, a, kw, outs):
        n = metered(func, a, kw, outs)
        by_op[str(func)] += n
        return n

    dryrun._op_bytes = tallied
    try:
        with dryrun.fake_world(512 if args.multi_pod else 256):
            res = dryrun.run_cell(args.arch, args.shape, args.multi_pod,
                                  verbose=False)
    finally:
        dryrun._op_bytes = metered
    if res["status"] != "OK":
        print(json.dumps(res))
        return 1
    total = sum(by_op.values())
    print(json.dumps(dict(
        arch=args.arch, shape=args.shape, multi_pod=args.multi_pod,
        bytes_accessed=res["bytes_accessed"], tallied=total,
        top=[dict(op=op, bytes=n, share=n / total)
             for op, n in by_op.most_common(args.top)])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
