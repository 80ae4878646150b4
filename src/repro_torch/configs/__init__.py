"""Ported architecture registry: every config of the reference. Each module
defines CONFIG, the exact published configuration, and cites its source in
the docstring. The configs are data: ``cluster.perf_model`` reads every
arch's ``param_count()``/``active_param_count()`` to build a pipeline's
variants. The dense, audio and ssm families have model code so far;
``models.api`` refuses the others (ROADMAP Queue 1 item 11 part B)."""
from repro_torch.configs import (
    granite_moe_3b_a800m,
    granite_3_8b,
    llava_next_mistral_7b,
    deepseek_67b,
    starcoder2_3b,
    llama3_2_1b,
    whisper_small,
    zamba2_2_7b,
    xlstm_125m,
    llama4_maverick_400b_a17b,
)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        granite_moe_3b_a800m, granite_3_8b, llava_next_mistral_7b, deepseek_67b,
        starcoder2_3b, llama3_2_1b, whisper_small, zamba2_2_7b, xlstm_125m,
        llama4_maverick_400b_a17b,
    )
}


def get_arch(name: str):
    return ARCHS[name]
