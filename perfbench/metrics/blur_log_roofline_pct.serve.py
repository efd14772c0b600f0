"""``blur_log``'s share of its roofline at the cell's decode shape ``[B,
h, w, K]`` float32: the least time from ``costs/blur_log.py`` at 3.35 TB/s
over the profiled launches' device time (kernel ``blur_log_*``)."""

from perfbench.core.readers import roofline_pct


def read(run):
    cfg = run.cell.port_config(run.overrides)
    h, w = cfg.DATASET.heatmap_size
    shape = (int(run.cell.mix["batch"]), h, w, int(cfg.DATASET.num_joints))
    return roofline_pct(run, "blur_log", "blur_log", [shape], 4)
