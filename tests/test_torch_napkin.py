"""The port's analysis tools against the reference's: the input shapes and
cells of ``repro_torch.configs`` (``SHAPES``, ``skip_reason``, ``cells``)
and the napkin roofline ``repro_torch.launch.napkin.analytic_terms``.

For every (arch, shape) cell the napkin's FLOPs, HBM bytes and collective
bytes per device equal the reference's, at the reference dry run's two
meshes (256 chips, and 512 across two pods), and each time term is its
count over the H100 SXM's rate from its datasheet (dense bf16 989
TFLOP/s, HBM3 3.35 TB/s, NVLink 4 450 GB/s per direction), where the
reference divides by a TPU v5e's."""
import pytest

from repro_torch import configs as tconfigs
from repro_torch.launch import napkin as tnapkin
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

COUNTS = ("flops_per_device", "bytes_per_device",
          "collective_bytes_per_device")
N_CHIPS = (256, 512)


@pytest.fixture(scope="module")
def ref():
    from repro import configs
    from repro.launch import napkin
    return configs, napkin


def test_shapes_and_cells_are_the_reference(ref):
    configs, _ = ref
    assert tconfigs.SHAPES == configs.SHAPES
    assert tconfigs.cells(include_skipped=True) == \
        configs.cells(include_skipped=True)
    assert tconfigs.cells() == configs.cells()
    for arch in tconfigs.ARCH_IDS:
        for shape in tconfigs.SHAPES:
            assert tconfigs.skip_reason(tconfigs.get(arch), shape) == \
                configs.skip_reason(configs.get(arch), shape)


def test_h100_constants():
    assert (tnapkin.H100_SXM_PEAK_FLOPS, tnapkin.H100_SXM_HBM_BW,
            tnapkin.H100_SXM_NVLINK_BW) == (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in
                                        tconfigs.cells()])
def test_napkin_counts_equal_the_reference(ref, arch, shape):
    configs, napkin = ref
    tcfg, rcfg = tconfigs.get(arch), configs.get(arch)
    for n in N_CHIPS:
        got = tnapkin.analytic_terms(tcfg, shape, n)
        want = napkin.analytic_terms(rcfg, shape, n)
        for k in COUNTS:
            assert got[k] == want[k], (n, k)
        assert got["t_compute_s"] == \
            got["flops_per_device"] / tnapkin.H100_SXM_PEAK_FLOPS
        assert got["t_memory_s"] == \
            got["bytes_per_device"] / tnapkin.H100_SXM_HBM_BW
        assert got["t_collective_s"] == \
            got["collective_bytes_per_device"] / tnapkin.H100_SXM_NVLINK_BW
