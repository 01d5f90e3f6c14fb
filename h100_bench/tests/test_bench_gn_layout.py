"""The gn_nhwc_share.* readers on hand-made summaries: the share of K4's
records in its channels-last design, none without a K4 record, each in its
own kind of cell."""

from h100_bench import driver

K4 = "void (anonymous namespace)::md_group_norm_kernel<__nv_bfloat16, 8>(...)"
K4_NHWC = "void (anonymous namespace)::md_group_norm_kernel_nhwc<__nv_bfloat16, 8>(...)"


def test_share_of_channels_last_records():
    names = [K4, K4_NHWC, K4_NHWC, K4_NHWC, "sm90_xmma_fprop_implicit_gemm", "elementwise"]
    serve = driver.load_reader("gn_nhwc_share.serve")
    train = driver.load_reader("gn_nhwc_share.train")
    assert serve({"kind": "serve", "names": names}) == 75.0
    assert train({"kind": "train", "names": names}) == 75.0
    assert serve({"kind": "train", "names": names}) is None
    assert train({"kind": "serve", "names": names}) is None


def test_no_reading_without_a_k4_record_and_zero_for_nchw_alone():
    train = driver.load_reader("gn_nhwc_share.train")
    assert train({"kind": "train", "names": ["elementwise"]}) is None
    assert train({"kind": "train", "names": [K4, K4]}) == 0.0
