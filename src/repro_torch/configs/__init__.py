"""Architecture registry: --arch <id> resolves here (a copy of the JAX
package's registry and its ten config files, as data)."""
from repro_torch.configs.base import ArchConfig, MoECfg, SSMCfg
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2vl
from repro_torch.configs.qwen1_5_110b import CONFIG as _qwen110b
from repro_torch.configs.h2o_danube_1_8b import CONFIG as _danube
from repro_torch.configs.llama3_8b import CONFIG as _llama3
from repro_torch.configs.gemma3_4b import CONFIG as _gemma3
from repro_torch.configs.whisper_small import CONFIG as _whisper
from repro_torch.configs.deepseek_moe_16b import CONFIG as _dsmoe
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3moe
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba

ARCHS = {c.name: c for c in [
    _qwen2vl, _qwen110b, _danube, _llama3, _gemma3,
    _whisper, _dsmoe, _qwen3moe, _falcon, _zamba,
]}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ArchConfig", "MoECfg", "SSMCfg", "ARCHS", "get_config"]
