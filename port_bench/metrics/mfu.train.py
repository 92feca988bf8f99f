"""Model FLOPs of forward and backward per example (rooflines/
model_<model>.py, no recompute) times the window's examples per second,
over the card's TF32 tensor peak (rooflines/peaks.json), in percent."""

from harness import roofline


def read(run):
    if run.window_s <= 0 or not run.device_name:
        return None
    m = roofline.model(run.cell.cfg["model_type"])
    peak = roofline.peaks(run.device_name)["flops_per_s"]
    return 100.0 * m.train_flops_per_example(run.shapes) * run.rate / peak
