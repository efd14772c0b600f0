"""``moments``'s share of its roofline over a train step: the sum over the
step's BatchNorm sites at C % 128 == 0 (the program sends those to the
kernel) of the least time from ``costs/moments.py`` at 3.35 TB/s, float32,
over the summed device time of the profiled ``moments_kernel`` launches.
The sites' shapes come from the reference model on the meta device."""

import torch

from perfbench.core import spec
from perfbench.core.readers import roofline_pct
from perfbench.reference.common import batchnorm_inputs


def read(run):
    cfg = run.cell.port_config(run.overrides)
    with torch.device("meta"):
        model = spec.reference(run.cell.config["reference"]).build(
            run.cell.model_spec(run.overrides))
        x = torch.empty(int(run.cell.mix["batch"]), 3,
                        *cfg.DATASET.image_size)
    sites = [s for s in batchnorm_inputs(model, x) if s[1] % 128 == 0]
    return roofline_pct(run, "moments", "moments_kernel", sites, 4)
