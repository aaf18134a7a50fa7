"""Kernels B1 and B3's register-pass kernel (csrc/fft_common.cuh,
reg_psd_kernel) and the four-step split of B1 and B3 at 32768 and of B4
(fs_cols_kernel, fs_rows_kernel), their own source compiled by g++ against
a CPU emulation of the CUDA it uses (tests/cuda_emulation: one thread per
CUDA thread, a barrier for __syncthreads, launches one block after
another), against ops.plain.psd_torch.

This is no test of the card: it cannot see a data race the barriers
leave, bank conflicts, registers or speed, and g++ rounds without the
card's fused multiply-adds. It runs the kernel's index arithmetic, its
exchanges through the shared buffer, its barriers' placement (a missing
one can show as a wrong result) and its Welch sums for every size, both
start policies (StartsArray for B1, StartsHop for B3) and both sample
dtypes, at the kernels' tolerance (rtol 2e-4, atol 1e-6; B4's rtol 2e-3
plus 1e-4 of the column's mean at 65536 and 131072), and that every output
bin is written.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pyspectrogram_tpu_torch.kernels._build import CSRC, psd_device_constants
from pyspectrogram_tpu_torch.ops import plain

HERE = Path(__file__).resolve().parent / "cuda_emulation"
LIN = dict(rtol=2e-4, atol=1e-6)
SIZES = [256, 512, 1024, 2048, 4096, 8192, 16384]


def emulated_source(src: str) -> str:
    """fft_common.cuh for g++: no CUDA runtime header, launches as plain
    calls (the launch functions are templates the harness never
    instantiates), and the block's shared buffers as arrays of the
    anonymous namespace the kernels declare them in."""
    src = src.replace("#include <cuda_runtime.h>", "")
    src = re.sub(r"(\w+)<<<.*?>>>\(", r"\1(", src, flags=re.S)
    return src.replace("namespace {", "namespace {\n"
                       "float2 sbuf[65536];", 1)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulation")
    d = tmp_path_factory.mktemp("cuda_emulation")
    (d / "fft_common_emu.cuh").write_text(
        emulated_source((CSRC / "fft_common.cuh").read_text()))
    exe = d / "harness"
    res = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-w", f"-I{HERE}", f"-I{d}",
         "-o", str(exe), str(HERE / "harness.cpp")],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return exe


def _run(exe, tmp, x, starts, *, nfft, nint, mode, ref, policy, hop):
    nseg = nint if mode == "welch" else 1
    win, tw, inv = psd_device_constants(nfft, nint, mode, ("kaiser", 1.7),
                                        ref, torch.device("cpu"))
    inp, out = tmp / "in.bin", tmp / "out.bin"
    with open(inp, "wb") as f:
        for a in (x, starts.astype(np.int32), win.numpy(), tw.numpy(),
                  np.float32(inv)):
            f.write(np.ascontiguousarray(a).tobytes())
    nsub, nsamp = x.shape[0] // 2, x.shape[1]
    subprocess.run([str(exe), str(nfft), "1" if x.dtype == np.int16 else "0",
                    str(nsub), str(nsamp), str(len(starts)), str(nseg),
                    str(policy), str(hop), str(tw.numel() // 2), str(inp),
                    str(out)], check=True, timeout=300)
    return np.fromfile(out, np.float32).reshape(len(starts), nsub, nfft)


def _b4_check(got, want):
    """B4's tolerance: rtol 2e-3 plus 1e-4 of the column's mean (a
    white-noise bin's power is ~1/nfft)."""
    lim = 2e-3 * np.abs(want) + 1e-4 * want.mean(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= lim).all(), np.abs(got - want).max()


@pytest.mark.parametrize("nfft,policy", [
    (nfft, policy) for policy in ("array", "hop") for nfft in SIZES] + [
    (32768, "array"), (32768, "hop"), (65536, "array"), (131072, "array")])
def test_emulated_kernel_matches_plain(harness, tmp_path, nfft, policy):
    """Welch over 3 segments on float32 planes and parity on int16 planes,
    two subchannels, three columns (two from 32768 on, each four-step case
    taking ~10 s here): starts clamped at both ends (B1, B4) or t*hop with
    overlapping frames (B3). 32768 is B1's and B3's four-step split at
    their tolerance; 65536 and 131072 (N1 = 512 != N2 = 256) are B4's."""
    rng = np.random.default_rng(nfft + (policy == "hop"))
    ntime, nsub = (3 if nfft <= SIZES[-1] else 2), 2
    for mode, nint, dtype in (("welch", 3, "float32"), ("parity", 2, "int16")):
        fl = nfft * nint if mode == "welch" else nfft
        hop = 3 * nfft // 8 + 12
        nsamp = fl - hop + ntime * hop if policy == "hop" else fl * ntime + 77
        if dtype == "int16":
            x = rng.integers(-2 ** 14, 2 ** 14, (2 * nsub, nsamp)).astype(
                np.int16)
            ref = 2.0 ** 15.5
        else:
            x = rng.standard_normal((2 * nsub, nsamp)).astype(np.float32)
            ref = 1.0
        starts = (np.arange(ntime) * hop if policy == "hop"
                  else np.array([-40, nsamp // 3, nsamp][:ntime - 1]
                                + [nsamp]))
        got = _run(harness, tmp_path, x, starts, nfft=nfft, nint=nint,
                   mode=mode, ref=ref, policy=int(policy == "hop"), hop=hop)
        assert np.isfinite(got).all(), "a bin was not written"
        want = plain.psd_torch(torch.from_numpy(x),
                               torch.from_numpy(starts.astype(np.int32)),
                               nfft=nfft, nint=nint, mode=mode, ref=ref)
        if nfft > 32768:
            _b4_check(got, want.numpy())
        else:
            np.testing.assert_allclose(got, want.numpy(), **LIN)
