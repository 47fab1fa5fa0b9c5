#!/usr/bin/env python3
"""The host zstd decoder's rate on a Huffman-heavy payload: f32 noise compressed by ``zstandard``.

Run from the repository root: ``python scripts/zstd_decode_rate.py [--mib 64] [--threads 8]``.
It needs the ``zstandard`` package to compress (the decoder under test is the
port's C++ one, ``skillful_nowcasting_tpu_torch/hostsrc/zstd.cpp``, built at
first use) and prints, for one thread and for ``--threads`` threads decoding
chunks of 4 MiB at once, the decoded MB/s beside ``zstandard``'s own
single-thread rate on the same frames, and the host it ran on.
"""

import argparse
import os
import platform
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from skillful_nowcasting_tpu_torch.ckpt_format import zstd  # noqa: E402


def best_of(fn, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> None:
    import zstandard

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mib", type=int, default=64)
    parser.add_argument("--threads", type=int, default=min(8, os.cpu_count() or 1))
    parser.add_argument("--level", type=int, default=1, help="zstd level (Orbax writes 1)")
    args = parser.parse_args()
    chunk = 4 << 20
    rng = np.random.default_rng(0)
    data = [rng.standard_normal(chunk // 4).astype(np.float32).tobytes()
            for _ in range(args.mib * (1 << 20) // chunk)]
    frames = [zstandard.ZstdCompressor(level=args.level).compress(d) for d in data]
    total = sum(map(len, data))
    outs = [bytearray(chunk) for _ in frames]
    zstd.decompress_into(frames[0], outs[0])  # builds the decoder
    if any(zstd.decompress(f) != d for f, d in zip(frames, data)):
        raise SystemExit("decoded bytes differ from the input")

    def one_thread():
        for f, o in zip(frames, outs):
            zstd.decompress_into(f, o)

    def threads(pool):
        list(pool.map(zstd.decompress_into, frames, outs))

    reference = zstandard.ZstdDecompressor()
    t1 = best_of(one_thread, 3)
    with ThreadPoolExecutor(args.threads) as pool:
        tn = best_of(lambda: threads(pool), 3)
    tz = best_of(lambda: [reference.decompress(f) for f in frames], 3)
    print(f"host: {platform.processor() or platform.machine()}, {os.cpu_count()} CPUs "
          f"(a CPU figure, not a device one)")
    print(f"payload: {total} bytes of f32 noise in {len(frames)} frames of {chunk} bytes, "
          f"zstd level {args.level}, compressed to {sum(map(len, frames))} bytes")
    print(f"port decoder: {total / t1 / 1e6:.1f} MB/s on 1 thread, "
          f"{total / tn / 1e6:.1f} MB/s on {args.threads} threads; "
          f"zstandard {zstandard.__version__}: {total / tz / 1e6:.1f} MB/s on 1 thread")


if __name__ == "__main__":
    main()
