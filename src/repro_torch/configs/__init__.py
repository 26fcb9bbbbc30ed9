"""Assigned architecture configs (``--arch <id>``).

Each module defines ``FULL`` (the exact published config) and ``SMOKE`` (a
reduced same-family config for CPU tests).  ``repro_torch.models.registry``
collects them.
"""

from . import (
    dbrx_132b,
    h2o_danube_3_4b,
    internlm2_20b,
    jamba_v01_52b,
    llava_next_mistral_7b,
    moonshot_v1_16b_a3b,
    qwen15_110b,
    starcoder2_7b,
    whisper_large_v3,
    xlstm_1_3b,
)

ALL = {
    m.FULL.name: m
    for m in (
        qwen15_110b,
        starcoder2_7b,
        internlm2_20b,
        h2o_danube_3_4b,
        dbrx_132b,
        moonshot_v1_16b_a3b,
        xlstm_1_3b,
        jamba_v01_52b,
        whisper_large_v3,
        llava_next_mistral_7b,
    )
}
