"""Every attention config of ``repro_torch.configs`` has a head width that
kernel K7 is built for, at full width and reduced, and a bf16 config at
full width lands on K7's tensor-core instantiation. This needs no card: it
reads the configs and the wrapper's tables.

    PYTHONPATH=src python -m pytest -q tests/test_torch_head_widths.py
"""
import pytest

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.flash_attention import HEAD_DIMS, SM90_HEAD_DIMS

ATTENTION = sorted(n for n in ARCHS if not get_config(n).attention_free)


def test_the_attention_configs_are_all_there():
    assert "h2o-danube-1.8b" in ATTENTION and "falcon-mamba-7b" not in ATTENTION


@pytest.mark.parametrize("name", ATTENTION)
def test_k7_takes_the_configs_head_width(name):
    cfg = get_config(name)
    assert cfg.head_dim in HEAD_DIMS, (name, cfg.head_dim)
    assert cfg.reduced().head_dim in HEAD_DIMS
    if cfg.dtype == "bfloat16":
        assert cfg.head_dim in SM90_HEAD_DIMS, (name, cfg.head_dim)


def test_h2o_danube_is_head_width_80():
    cfg = get_config("h2o-danube-1.8b")
    assert cfg.d_head is None and cfg.head_dim == 2560 // 32 == 80
