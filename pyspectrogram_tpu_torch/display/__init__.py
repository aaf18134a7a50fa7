"""Display of the port: the uint8 tiles and colour quantization on the
device, the host LUT and the PNG, CSV and ``.npz`` writers — the names of
the JAX package's ``display`` (colormap is its own, jax-free module)."""

from pyspectrogram_tpu.display.colormap import (
    get_colormap,
    quantize_levels,
    rgba_lut,
    spectral_legacy_colors,
    viridis_colors,
)
from pyspectrogram_tpu_torch.display.render import (
    apply_lut,
    freq_crop_decimate,
    quantize_on_device,
    save_psd_csv,
    save_result_npz,
    save_sti_png,
    save_tile_png,
    sti_tile,
)
from pyspectrogram_tpu_torch.display.tile import (
    TileSpec,
    make_tile_spec,
    quantize_tile_linear,
    tile_freqs,
    tile_from_db,
    tile_from_linear,
)

__all__ = [
    "TileSpec",
    "apply_lut",
    "freq_crop_decimate",
    "get_colormap",
    "make_tile_spec",
    "quantize_levels",
    "quantize_on_device",
    "quantize_tile_linear",
    "rgba_lut",
    "save_psd_csv",
    "save_result_npz",
    "save_sti_png",
    "save_tile_png",
    "spectral_legacy_colors",
    "sti_tile",
    "tile_freqs",
    "tile_from_db",
    "tile_from_linear",
    "viridis_colors",
]
