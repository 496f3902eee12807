"""Serve a small model through the continuous-batching engine of the
PyTorch port: paged KV cache on the symmetric heap, one-pass prefill,
per-step join/evict with requests arriving every other engine step
(DESIGN.md §15).

Runs on the CUDA card unless given --device cpu.

Run:  PYTHONPATH=src python examples/pt_serve_batched.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch import serve as serve_mod  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return serve_mod.main([
        "--arch", "qwen2-0.5b", "--smoke", "--continuous",
        "--requests", "8", "--rate", "2", "--slots", "4",
        "--prompt-len", "16", "--tokens", "16", "--cache-len", "64",
        "--page-size", "8"]
        + ([] if args.device is None else ["--device", args.device]))


if __name__ == "__main__":
    main()
