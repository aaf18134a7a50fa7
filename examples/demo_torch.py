#!/usr/bin/env python
"""End-to-end demo of the PyTorch + CUDA port: synthesize -> view ->
stream -> filter -> regenerate.

The five steps of examples/demo.py on ``pyspectrogram_tpu_torch``, with the
same arguments, prints and artifacts, entirely headless:

    python examples/demo_torch.py /tmp/pstpu_torch_demo          # on cuda
    python examples/demo_torch.py /tmp/pstpu_torch_demo --device cpu

Writes: waterfall.png, psd.csv, stream.png, filtered WAV, and prints the
processor's event flow + latency stats. Steps 2-5 take an opened dataset
(:func:`run_steps`), so they also run on a capture served from memory
(``io.memory.MemoryDataset``) where there is no HDF5 reader.
"""

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

try:
    import pyspectrogram_tpu_torch  # noqa: F401
except ImportError:  # run from a checkout without installing
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pyspectrogram_tpu_torch.clients.cli import build_parser  # noqa: E402
from pyspectrogram_tpu_torch.display import (  # noqa: E402
    save_psd_csv,
    save_sti_png,
)
from pyspectrogram_tpu_torch.io import RFDataset  # noqa: E402
from pyspectrogram_tpu_torch.io.synthetic import write_capture  # noqa: E402
from pyspectrogram_tpu_torch.models import StiPipeline  # noqa: E402
from pyspectrogram_tpu_torch.ops.filters import (  # noqa: E402
    filter_signal,
    save_wav,
)
from pyspectrogram_tpu_torch.runtime import (  # noqa: E402
    ProcessorCallbacks,
    SpectrogramProcessor,
)
from pyspectrogram_tpu_torch.utils import SpectrogramConfig  # noqa: E402

#: step 1's capture: write_capture's arguments after the directory
CAPTURE = dict(channel="demo", kind="tone", n_samples=1 << 20,
               sample_rate_numerator=1_000_000, num_subchannels=2,
               freqs_hz=[125_000.0, -300_000.0], noise_rms=3e-4)


def main(outdir=None, device="cuda"):
    outdir = outdir or tempfile.mkdtemp(prefix="pstpu_torch_demo_")
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)

    drf = out / "capture"
    print(f"[1/5] writing synthetic 2-tone capture -> {drf}")
    write_capture(drf, **CAPTURE)
    run_steps(RFDataset(drf), out, device)


def run_steps(ds, out, device):
    """Steps 2-5 on the opened two-subchannel capture ``ds`` (channel
    "demo"), writing the artifacts under ``out`` and computing on
    ``device``."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    print("[2/5] one-shot STI + median PSD")
    cfg = SpectrogramConfig(nfft=4096, nint=2, ntime=128)
    res = StiPipeline(ds, cfg, device=device).compute()
    png = save_sti_png(str(out / "waterfall"), res.freqs, res.times,
                       res.sxx_dbfs[..., 0], colorrange=(-110, 0),
                       device=device)
    csv = save_psd_csv(str(out / "psd"), res.freqs, res.sxx_med_dbfs[:, 0])
    peak = res.freqs[np.argmax(res.sxx_med_dbfs[:, 0])]
    print(f"      peak at {peak/1e3:+.1f} kHz -> {png}, {csv}")

    print("[3/5] processor loop (3 iterations over the event surface)")
    events = []
    proc = SpectrogramProcessor(
        "written", ds, tab_id=1, config=cfg,
        callbacks=ProcessorCallbacks(on_iterated=lambda e: events.append(e.i)),
        written_sleep=0.0, max_iterations=3, device=device,
    )
    proc.run()
    print(f"      iterations {events}, latency {proc.latency_stats()}")

    print("[4/5] incremental streaming through the on-device ring")
    # pstpu-torch stream, with the opened dataset in place of its path
    args = build_parser().parse_args(
        ["stream", "DATASET", "--out", str(out / "stream.png"),
         "--nfft", "1024", "--cols-per-block", "8", "--ring-len", "128",
         "--renderer", "pixels", "--device", str(device)])
    args.dataset = ds
    if args.fn(args) != 0:
        raise RuntimeError("pstpu-torch stream failed")

    print("[5/5] low-pass filter + audio regeneration")
    lo, hi = ds.bnds["demo"]
    x = ds.read(lo, 1 << 17, "demo")[:, 0]
    y = filter_signal(x, 1e6, "lowpass", 200_000.0, nfft=2048, device=device)
    wav = save_wav(str(out / "filtered"), y[2048:-2048], 48_000)
    print(f"      kept the +125 kHz tone, removed -300 kHz -> {wav}")
    print(f"done: artifacts in {out}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir", nargs="?")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.outdir, a.device)
