"""k4_tile_scores_roofline: K4 at tile grain (pass 3 of ``ops/dense.py``
``tiled_dense_topk``) as a share (%) of its roofline in the traced window:
the least time of each ``ops/dense.py`` ``tile_scores`` call over the
device time of the operations it launched."""

from harness.kernel_bounds import roofline_pct, tile_scores

TAPS = {"tile_scores": ("hybridsearch_tpu_torch.ops.dense", "tile_scores")}


def read(run):
    if run.profile is None:
        return None
    return roofline_pct(run.calls.get("tile_scores"),
                        run.profile.device_s.get("tile_scores", 0.0),
                        tile_scores)
