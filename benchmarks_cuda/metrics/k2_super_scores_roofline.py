"""k2_super_scores_roofline: K2's share (%) of its roofline in the traced
window: the least time of each ``ops/supertile.py`` ``super_scores`` call
over the device time of the operations it launched."""

from harness.kernel_bounds import roofline_pct, super_scores

TAPS = {"super_scores": ("hybridsearch_tpu_torch.ops.supertile", "super_scores")}


def read(run):
    if run.profile is None:
        return None
    return roofline_pct(run.calls.get("super_scores"),
                        run.profile.device_s.get("super_scores", 0.0),
                        super_scores)
