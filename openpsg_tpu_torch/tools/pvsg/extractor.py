"""PVSG video preparation (counterpart of ``tools/pvsg/extractor.py``):
every frame of each video written as a PNG, ``{image_dir}/{video}/{i:04d}.png``,
for ``pvsg.infer_video``.

    python -m openpsg_tpu_torch.tools.pvsg.extractor [--video-dir V]
        [--image-dir I] [--ext mp4]

Reading video needs cv2 (``cv2.VideoCapture``); the frames are written by
``cv2.imwrite``, as the JAX tool writes them.
"""

from __future__ import annotations

import argparse
import glob
import os


def extract(video_dir: str, image_dir: str, ext: str = "mp4") -> int:
    """Dump the frames of every ``*.{ext}`` in ``video_dir`` → the number of
    frames written."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("the PVSG frame extractor needs cv2 (cv2.VideoCapture) to read "
                          "video; install opencv-python") from e

    count = 0
    for video_path in sorted(glob.glob(os.path.join(video_dir, f"*.{ext}"))):
        name = os.path.splitext(os.path.basename(video_path))[0]
        out_dir = os.path.join(image_dir, name)
        os.makedirs(out_dir, exist_ok=True)
        cap = cv2.VideoCapture(video_path)
        idx = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            cv2.imwrite(os.path.join(out_dir, f"{idx:04d}.png"), frame)
            idx += 1
        cap.release()
        print(f"{name}: {idx} frames")
        count += idx
    return count


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m openpsg_tpu_torch.tools.pvsg.extractor")
    ap.add_argument("--video-dir", default="./data/pvsg/vidor/videos")
    ap.add_argument("--image-dir", default="./data/pvsg/vidor/images")
    ap.add_argument("--ext", default="mp4")
    args = ap.parse_args(argv)
    return extract(args.video_dir, args.image_dir, args.ext)


if __name__ == "__main__":
    main()
