"""Times of the port's PSD and median kernels on one NVIDIA GPU, for
comparing two checkouts of the port in one run on one card.

    python3 kernel_times.py [--tree DIR] [--label NAME]

Imports ``pyspectrogram_tpu_torch`` from DIR (default: this script's own
checkout), builds its kernels there, and times each kernel at the shapes
chip_smoke.py reports: B1 at the reference default (nfft 1024, nint 1,
ntime 100), the headline (4096, 4, 128), 16384 x 4 x 32 and 32768 x 4 x 16;
B3 on the overlap-2048 push buffer (nfft 4096, hop 2048, 8 columns); B4 at
65536 x 4 x 32 and 2^20 x 1 x 16; B2 over the headline's power cube; and
the four-step split's two launches (columns, rows) alone and as a pair at
B1's 32768 x 4 x 16 and B4's two shapes, with its column chunking against
chunks of half the L2 and the profiler's event count against the
launches. Two
subchannels everywhere, float32 planes from a seeded generator on the
card. A first line gives ptxas's registers and spill bytes of the
register-pass PSD kernel per nfft (fresh builds only). Each shape prints one
JSON line: CUDA-event ms per call over
back-to-back calls, the profiler's device ms (null when no trace held a
device event), the bound and the card's name and power limit. The timing
and bound helpers are those of DIR's bench module
(pyspectrogram_tpu_torch.bench), and chip_smoke.py's ptxas and four-step
helpers are DIR's own where DIR holds chip_smoke.py, so DIR's port must
have the bench module. To compare a change
with its parent, unpack the parent into a directory that .gitignore lists
and run, in one command, parent, change, change, parent. Needs a CUDA
device; imports torch, numpy and the port.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def four_step_launches(torch, big_cuda, sti_cuda, gen, dev, label, card,
                       nfft, nint, ntime):
    """One JSON line for the four-step split at nfft x nint x ntime x 2:
    CUDA-event ms of launch 1 (columns) alone, launch 2 (rows) alone and
    the pair, over all columns in one launch pair
    (chip_smoke.four_step_launch_ms); the wrapper's ms with its workspace
    in chunks of up to WORKSPACE_MAX_BYTES and, event and device ms, in
    chunks of half the card's L2; the profiler's device ms and device
    events over 5 and over 20 calls of the wrapper, beside the launches
    those calls made."""
    import chip_smoke
    from pyspectrogram_tpu_torch import bench

    x = torch.randn((4, nfft * nint * ntime), generator=gen, device=dev)
    sd = torch.arange(ntime, dtype=torch.int32, device=dev) * nfft * nint
    kw = dict(nfft=nfft, nint=nint, mode="welch")
    wrapper = sti_cuda.sti_psd_cuda
    launches = chip_smoke.four_step_launch_ms(x, sd, nfft, nint)
    col_bytes = 2 * nint * nfft * 8
    chunk = big_cuda.chunk_columns(ntime, col_bytes,
                                   big_cuda.WORKSPACE_MAX_BYTES)
    half_l2 = torch.cuda.get_device_properties(dev).L2_cache_size // 2
    line = {"tree": label, "kernel": "four_step",
            "shape": [nfft, nint, ntime, 2], **launches,
            "chunk_columns": chunk,
            "wrapper_ms": bench.event_ms(lambda: wrapper(x, sd, **kw),
                                         iters=20),
            "half_l2_bytes": half_l2,
            "half_l2_chunk_columns": big_cuda.chunk_columns(
                ntime, col_bytes, half_l2)}
    saved = big_cuda.WORKSPACE_MAX_BYTES
    big_cuda.WORKSPACE_MAX_BYTES = half_l2
    try:
        line["wrapper_half_l2_ms"] = bench.event_ms(
            lambda: wrapper(x, sd, **kw), iters=20)
        line["device_ms_half_l2"] = bench.device_ms(
            lambda: wrapper(x, sd, **kw))
    finally:
        big_cuda.WORKSPACE_MAX_BYTES = saved
    n_chunks = -(-ntime // chunk)
    for iters in (5, 20):
        ms, events = bench.traced_device_ms(lambda: wrapper(x, sd, **kw),
                                            iters=iters)
        line[f"device_ms_{iters}"] = ms
        line[f"device_events_{iters}"] = events
        line[f"launches_{iters}"] = 2 * n_chunks * iters
    line["card"] = card
    print(json.dumps(line), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(HERE),
                    help="checkout whose pyspectrogram_tpu_torch is timed")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from pyspectrogram_tpu_torch import bench
    from pyspectrogram_tpu_torch.kernels import (
        big_cuda,
        median_cuda,
        stream_cuda,
        sti_cuda,
    )

    from pyspectrogram_tpu_torch.kernels import _build

    mod = Path(sti_cuda.__file__).resolve()
    if tree not in mod.parents:
        raise RuntimeError(f"kernel_times: imported {mod}, not from {tree}")
    _build.library()
    card = bench.card_of("cuda")
    label = args.label or tree.name
    # ptxas's registers and spills of the register-pass kernel and of the
    # four-step split's two launches, per nfft (empty when the library came
    # from the build directory)
    log = _build.build_log
    fs = chip_smoke.four_step_resources(log)
    print(json.dumps({
        "tree": label,
        "ptxas_reg_psd": chip_smoke.ptxas_summary(
            chip_smoke.reg_kernel_resources(log)),
        "ptxas_four_step_cols": chip_smoke.ptxas_summary(
            [k for k in fs if k["launch"] == "cols"]),
        "ptxas_four_step_rows": chip_smoke.ptxas_summary(
            [k for k in fs if k["launch"] == "rows"])}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def emit(kernel, shape, fn, bound):
        fn()
        torch.cuda.synchronize()
        print(json.dumps({
            "tree": label, "kernel": kernel, "shape": shape,
            "ms": bench.event_ms(fn),
            "device_ms": bench.device_ms(fn),
            "bound_ms": bound[0], "bound_by": bound[1], "card": card}),
            flush=True)

    for nfft, nint, ntime in ((1024, 1, 100), (4096, 4, 128),
                              (16384, 4, 32), (32768, 4, 16)):
        x = torch.randn((4, nfft * nint * ntime), generator=gen, device=dev)
        sd = torch.arange(ntime, dtype=torch.int32, device=dev) * nfft * nint
        kw = dict(nfft=nfft, nint=nint, mode="welch")
        p = sti_cuda.sti_psd_cuda(x, sd, **kw)
        emit("sti_psd", [nfft, nint, ntime, 2],
             lambda: sti_cuda.sti_psd_cuda(x, sd, **kw),
             bench.psd_bound((x, sd), p, nfft, ntime * 2 * nint))
        if nfft == 4096:
            med = median_cuda.median_over_time_cuda(p)
            emit("median", list(p.shape),
                 lambda: median_cuda.median_over_time_cuda(p),
                 bench.median_bound(p, med))
    k, hop, nfft = 8, 2048, 4096
    buf = torch.randn((4, nfft - hop + k * hop), generator=gen, device=dev)
    got = stream_cuda.stream_psd_cuda(buf, nfft=nfft, hop=hop)
    emit("stream_psd", [nfft, 1, k, 2, hop],
         lambda: stream_cuda.stream_psd_cuda(buf, nfft=nfft, hop=hop),
         bench.psd_bound((buf,), got, nfft, k * 2))
    for nfft, nint, ntime in ((1 << 16, 4, 32), (1 << 20, 1, 16)):
        x = torch.randn((4, nfft * nint * ntime), generator=gen, device=dev)
        sd = torch.arange(ntime, dtype=torch.int32, device=dev) * nfft * nint
        kw = dict(nfft=nfft, nint=nint, mode="welch")
        p = big_cuda.big_psd_cuda(x, sd, **kw)
        emit("big_psd", [nfft, nint, ntime, 2],
             lambda: big_cuda.big_psd_cuda(x, sd, **kw),
             bench.psd_bound((x, sd), p, nfft, ntime * 2 * nint))
        del x, p
    if hasattr(big_cuda, "launch_cols"):
        for nfft, nint, ntime in ((1 << 15, 4, 16), (1 << 16, 4, 32),
                                  (1 << 20, 1, 16)):
            four_step_launches(torch, big_cuda, sti_cuda, gen, dev, label,
                               card, nfft, nint, ntime)
    print(json.dumps({"ok": True, "tree": label, "card": card,
                      "kind": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
