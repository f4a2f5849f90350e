"""ML ingest on the PyTorch/CUDA port: disk -> preprocessing pipeline ->
torch train step.

The counterpart of ``examples/ml_ingest.py``: a y4m clip written by
``videotestsrc ! y4menc`` is read by ``filesrc`` (the native mmap + prefetch
reader), staged to the card, converted and resized to the model's input by
``videoconvertscale``, and the RGB batches feed a toy model's train step,
normalised by /255, without visiting host pixel code.

    python3 examples/ml_ingest_torch.py [--frames N] [--batch N] [--cpu]

Runs on the CUDA card unless --cpu is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gstreamer_tpu_torch import parse_launch  # noqa: E402
from gstreamer_tpu_torch.core.pipeline import State  # noqa: E402


def make_dataset(path: str, frames: int = 64, device=None) -> None:
    """Write a y4m clip to ingest (stand-in for a real camera dump)."""
    parse_launch(
        f"videotestsrc num-buffers={frames} pattern=ball ! "
        "video/x-raw,format=I420,width=640,height=360,framerate=30/1 ! "
        f"y4menc location={path}", device=device).run()


def train(clip: str, batch: int = 16, device=None, seed: int = 0):
    """Ingest `clip` through the pipeline and take one train step a tick.
    Returns (frames, steps, last loss)."""
    p = parse_launch(
        f"filesrc location={clip} ! videoconvertscale ! "
        "video/x-raw,format=RGB,width=224,height=224 ! appsink name=out",
        device=device)
    p.compile(batch=batch, prefetch=True)
    sink = p.get_by_name("out")
    dev = p.device
    gen = torch.Generator(device="cpu").manual_seed(seed)
    w = (torch.randn(224 * 224 * 3, 10, generator=gen) * 0.01).to(dev)
    w.requires_grad_(True)
    opt = torch.optim.SGD([w], lr=1e-4)
    frames = steps = 0
    loss = None
    p.set_state(State.PLAYING)
    while p.tick():
        while True:
            s = sink.pull_sample()
            if s is None:
                break
            r, g, b = s.buffer.data                     # (B, 224, 224) each
            x = torch.stack([r, g, b], dim=-1).reshape(r.shape[0], -1)
            x = x.to(torch.float32) / 255
            loss = torch.mean(torch.square(x @ w))
            opt.zero_grad()
            loss.backward()
            opt.step()
            frames += r.shape[0]
            steps += 1
    p.set_state(State.NULL)
    return frames, steps, float(loss.detach())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    device = "cpu" if args.cpu else None
    with tempfile.TemporaryDirectory() as d:
        clip = os.path.join(d, "train.y4m")
        make_dataset(clip, args.frames, device)
        t0 = time.perf_counter()
        frames, steps, loss = train(clip, args.batch, device)
        if device is None:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    print(f"ingested+trained on {frames} frames in {steps} steps in "
          f"{dt:.2f} s, final loss {loss:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
