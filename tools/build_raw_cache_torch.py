"""Build per-scene raw uint8 frame caches for the PyTorch port
(``tools/build_raw_cache.py`` on ``mickey_tpu_torch.data.raw_cache``; numpy,
cv2 and the port only).

One decode of a Map-free split at the working resolution; afterwards the
port's loader and submission path read the frames as a memcpy, on a machine
with or without an image decoder. The files are the JAX tool's, byte for
byte, so a cache built by either tool serves both packages.

    python tools/build_raw_cache_torch.py --dataset /path/mapfree --split val \\
        [--width 540 --height 720] [--scenes s00460 s00461] [--overwrite]

Disk cost: ~1.1 MB per frame at 540x720 (uint8 HWC).
"""

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True, help="Map-free dataset root")
    parser.add_argument("--split", default="val", choices=("train", "val", "test"))
    parser.add_argument("--width", type=int, default=540)
    parser.add_argument("--height", type=int, default=720)
    parser.add_argument("--scenes", nargs="*", default=None)
    parser.add_argument("--overwrite", action="store_true")
    args = parser.parse_args(argv)

    from mickey_tpu_torch.data.raw_cache import build_scene_cache, list_scene_frames

    split_dir = Path(args.dataset) / args.split
    scenes = args.scenes or sorted(s.name for s in split_dir.iterdir() if s.is_dir())
    total = 0
    t0 = time.perf_counter()
    for i, scene in enumerate(scenes):
        n = len(list_scene_frames(split_dir / scene))
        build_scene_cache(split_dir / scene, (args.width, args.height), overwrite=args.overwrite)
        total += n
        print(f"[{i+1}/{len(scenes)}] {scene}: {n} frames", flush=True)
    dt = time.perf_counter() - t0
    print(f"cached {total} frames in {dt:.1f}s ({total/max(dt,1e-9):.1f} frames/s)", flush=True)


if __name__ == "__main__":
    main()
