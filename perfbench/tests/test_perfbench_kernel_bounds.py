"""Each kernel-bound file under `kernels/` gives the bound of `PERF.md`
section 6 at the shapes there (B 8, H 4, D 64, all keys valid; L 257 for
the [B, L, E] kernels, 4,097 for the classic ones; ms)."""

import pytest

from perfbench import spec

ROWS = [  # (kernel, template arguments, L, bound ms in PERF.md's table)
    ("flash_fwd_kernel", ["64", "true", "0"], 257, 0.00328),
    ("flash_fwd_wg_kernel", ["64", "true", "1"], 257, 0.00127),
    ("flash_fwd_wg_kernel", ["64", "true", "3"], 257, 0.00127),
    ("flash_bwd_fused_kernel", ["64", "true", "0"], 257, 0.0082),
    ("flash_bwd_wg_kernel", ["64", "true", "1"], 257, 0.00301),
    ("flash_bwd_wg_kernel", ["64", "true", "3"], 257, 0.00252),
    ("flash_fwd_kernel", ["64", "false", "0"], 4097, 0.8334),
    ("flash_fwd_wg_kernel", ["64", "false", "1"], 4097, 0.2781),
    ("flash_fwd_wg_kernel", ["64", "false", "3"], 4097, 0.2086),
    ("flash_bwd_dq_kernel", ["64", "0"], 4097, 1.250),
    ("flash_bwd_dq_wg_kernel", ["64", "1"], 4097, 0.3476),
    ("flash_bwd_dq_wg_kernel", ["64", "3"], 4097, 0.2086),
    ("flash_bwd_dkv_kernel", ["64", "0"], 4097, 1.667),
    ("flash_bwd_dkv_wg_kernel", ["64", "1"], 4097, 0.5561),
    ("flash_bwd_dkv_wg_kernel", ["64", "3"], 4097, 0.2781),
    ("flash_bwd_fused_kernel", ["64", "false", "0"], 257, 0.0082),
    ("flash_bwd_wg_kernel", ["64", "false", "1"], 257, 0.00301),
    ("flash_bwd_wg_kernel", ["64", "false", "3"], 257, 0.00222),
]


@pytest.mark.parametrize("name, targs, L, want_ms", ROWS)
def test_bound_matches_the_kernel_table(name, targs, L, want_ms):
    site = {"B": 8, "H": 4, "Lq": L, "Lk": L, "D": 64, "valid_keys": 8 * L}
    got = spec.kernel_bounds()[name].bound_s(site, targs, spec.peaks("NVIDIA H100 80GB HBM3"))
    assert got * 1e3 == pytest.approx(want_ms, rel=5e-3)


def test_every_kernel_file_is_in_the_table():
    assert set(spec.kernel_bounds()) == {r[0] for r in ROWS}


def test_template_arguments_of_a_trace_name():
    from perfbench.kernels._attention import template_args
    from perfbench.metrics._flash import kernel_of

    name = "void (anonymous namespace)::flash_fwd_wg_kernel<64, true, 1>(Args<__nv_bfloat16>)"
    assert template_args(name) == ["64", "true", "1"]
    assert kernel_of(name, spec.kernel_bounds()) == "flash_fwd_wg_kernel"
    assert kernel_of("void at::native::reduce_kernel<512, 1>(...)", spec.kernel_bounds()) is None
