"""Each op's operations and bytes, and the models' FLOP counts, against
counts by hand at tiny shapes; the kernel name maps against the symbols
the profiler printed on the card."""

import pytest

from harness import roofline


def cost(op, **s):
    return roofline.op(op).cost(s)


def test_target_attention_scorer_by_hand():
    # B=1, G=2, Lv=3 real of L=4, Dq=2, Dk=1, A0=2, A1=1:
    # key 3*2*2=12, query 2*2*2=8, per (l, g) 2*2+2*1+1+1=8 -> 3*2*8=48
    flops, nbytes = cost("target_attention_scorer", B=1, G=2, Lv=3, L=4,
                         Dq=2, Dk=1, A0=2, A1=1)
    assert flops == 2 * (12 + 8 + 48)
    # keys 3*1 + kp 3*2 + q 2*2 + mask 4 + out 2*1 + weights 16+2+2+2+1
    assert nbytes == 4 * (3 + 6 + 4 + 4 + 2 + 23)


def test_bn_stats_by_hand():
    s = dict(B=1, G=2, L=3, Dq=2, A0=2, A1=1)
    f0, b0 = cost("bn_stats0", **s)
    assert f0 == 2 * (3 * 2 * 2 + 2 * 2 * 2 + 3 * 2 * 2 * 2)
    assert b0 == 4 * (3 * 2 + 2 * 2 + 16 + 2 + 4)
    f1, b1 = cost("bn_stats1", **s)
    assert f1 == 2 * (3 * 2 * 2 + 2 * 2 * 2 + 3 * 2 * (2 * 2 + 2 * 1))
    assert b1 == 4 * (6 + 4 + 16 + 6 + 2 + 1 + 2)


def test_recurrence_by_hand():
    # B=2 rows, 3 real steps of 4, U=1, H=2: 3*1 + 7*4 = 31 a step
    f, b = cost("recurrence_forward", B=2, Lv=3, L=4, U=1, H=2, carries=0)
    assert f == 2 * 2 * 3 * 31
    assert b == 4 * (2 * 3 * (3 + 20) + 8 + 2 + 31 + 2 * 3 * 2 + 2 * 3)
    fc, bc = cost("recurrence_forward", B=2, Lv=3, L=4, U=1, H=2, carries=1)
    assert fc == f and bc == b + 4 * 2 * 3 * 7
    fb, bb = cost("recurrence_backward", B=2, Lv=3, L=4, U=1, H=2)
    assert fb == f
    assert bb == 4 * (2 * 3 * (7 + 23 + 2) + 8 + 2 * 3 * (23 + 3) + 6 + 31)


def test_row_update_by_hand():
    f, b = cost("row_update", rows=[(10, 4), (3, 2)])
    assert f == 0 and b == 4 * (10 * 34 + 3 * 18)


SHAPES = dict(B=2, K=1, G=3, L=4, mean_len=3.0, I=2, C=1,
              U=3, H=3, A0=2, A1=2, F0=2, F1=1, unique_items=5,
              unique_cates=2, unique_users=2)


def test_clsr_counts_by_hand():
    m = roofline.model("clsr")
    terms = dict(m.forward_macs(SHAPES, 3))
    # T = 3: the short attention's product term L*G*(U+T)*A0 = 4*3*6*2
    assert terms["short.product"] == 144
    assert terms["encoder.recurrence"] == 4 * (3 * 9 + 7 * 9)
    assert m.train_flops_per_example(SHAPES) == 6 * sum(terms.values())
    # the head over (H + T) = 6 inputs: G*((H+T)*F0 + F0*F1 + F1)
    assert terms["head"] == 3 * (6 * 2 + 2 * 1 + 1)


def test_sli_rec_counts_by_hand():
    m = roofline.model("sli_rec")
    terms = dict(m.forward_macs(SHAPES, 3))
    assert terms["encoder.recurrence"] == 4 * 4 * 3 * 3
    assert terms["head"] == 3 * (6 * 2 + 2 * 1 + 1)


@pytest.mark.parametrize("model", ["clsr", "sli_rec"])
def test_every_launch_has_an_op(model):
    for op, shapes in roofline.model(model).train_ops(SHAPES):
        flops, nbytes = roofline.op(op).cost(shapes)
        assert flops >= 0 and nbytes > 0


# symbols as the profiler printed them on the card
SEEN = {
    "void (anonymous namespace)::eval_scorer_kernel<80, 80, 40, 40>(float "
    "const*, float const*)": "target_attention_scorer",
    "void (anonymous namespace)::train_stats_kernel<40, 80, 40, 0>(float "
    "const*)": "bn_stats0",
    "void (anonymous namespace)::train_stats_kernel<80, 80, 40, 1>(float "
    "const*)": "bn_stats1",
    "void (anonymous namespace)::clsr_scan_kernel<40, 1>((anonymous "
    "namespace)::ScanArgs)": "recurrence_forward",
    "void (anonymous namespace)::clsr_scan_backward_kernel<40, 4>("
    "(anonymous namespace)::BwdArgs)": "recurrence_backward",
    "(anonymous namespace)::row_scatter_group_kernel((anonymous namespace)"
    "::Group)": "row_update",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<float> >(int)": None,
}


def test_kernel_names_map_to_ops():
    table = roofline.kernel_ops()
    for name, op in SEEN.items():
        assert roofline.op_of(name, table) == op, name


def test_kernel_share_counts_mapped_ops_only():
    peak = {"flops_per_s": 1e12, "bytes_per_s": 1e12}
    launches = [("row_update", dict(rows=[(1000, 10)]))]
    least = roofline.least_seconds("row_update", launches[0][1], peak)
    kernels = {"row_scatter_group_kernel": [2, 4 * least],
               "other_kernel": [5, 1.0]}
    assert roofline.kernel_share(kernels, launches, 2, peak) == \
        pytest.approx(50.0)
    assert roofline.kernel_share({"other": [1, 1.0]}, launches, 1,
                                 peak) is None


def test_peaks_of_the_card():
    p = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert p["flops_per_s"] == 495e12 and p["bytes_per_s"] == 3.35e12
