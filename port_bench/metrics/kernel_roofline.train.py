"""The hand-written kernels' share of their roofline in the traced train
calls: each mapped op's least time from its shapes (rooflines/<op>.py,
the larger of operations over the TF32 tensor peak and bytes over the
memory peak) over its kernels' device time (rooflines/names/*.json), in
percent."""

from harness import roofline


def read(run):
    t = run.trace_summary
    if not t or not t.get("steps"):
        return None
    m = roofline.model(run.cell.cfg["model_type"])
    return roofline.kernel_share(
        t["kernels"], m.train_ops(run.shapes), t["steps"],
        roofline.peaks(run.device_name))
