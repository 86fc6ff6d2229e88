"""k1_tile_stats_roofline: K1's share (%) of its roofline in the traced
window: the least time of each ``ops/dense.py`` ``tile_stats`` call (its
operations and bytes from its shapes, ``harness/kernel_bounds.py``) over
the device time of the operations it launched."""

from harness.kernel_bounds import roofline_pct, tile_stats

TAPS = {"tile_stats": ("hybridsearch_tpu_torch.ops.dense", "tile_stats")}


def read(run):
    if run.profile is None:
        return None
    return roofline_pct(run.calls.get("tile_stats"),
                        run.profile.device_s.get("tile_stats", 0.0), tile_stats)
