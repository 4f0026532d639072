"""The port's tools/mem_report.py against the JAX package's: at each
configuration of tests/test_mem_report.py (replicated, the ZeRO ladder,
pp-resident stages, the autoencoder) and at TP + ZeRO, every group's
global and per-rank MB (to the 0.01 MB both round to) and the totals are
JAX's, the port's state built on the meta device and placed by
parallel/mesh.py's rules (a jax-free child).  The port's report also
carries each group's bytes, which must round to its MB."""

import json
import os
import sys

import numpy as np
import pytest

TINY_BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=64,
                 max_position_embeddings=32, num_classes=1)
# name: (trainer, TrainingConfig overrides)
CONFIGS = {
    "replicated": ("mi", {}),
    "data4": ("mi", {"mesh_shape": (("data", 4),)}),
    "zero1": ("mi", {"mesh_shape": (("data", 4),),
                     "zero1_optimizer_sharding": True}),
    "zero1_fsdp": ("mi", {"mesh_shape": (("data", 4),),
                          "zero1_optimizer_sharding": True,
                          "fsdp_parameter_sharding": True}),
    "pp_resident": ("mi", {"mesh_shape": (("data", 2), ("pipe", 2))}),
    "tp_zero1": ("mi", {"mesh_shape": (("data", 2), ("model", 2)),
                        "zero1_optimizer_sharding": True}),
    "ae_zero1_fsdp": ("ae", {"mesh_shape": (("data", 4),),
                             "zero1_optimizer_sharding": True,
                             "fsdp_parameter_sharding": True}),
}

# the groups whose per-rank MB differ, and why.  Under TP (+ ZeRO-1) the
# port places every optimizer moment as its parameter at once: the text
# tower's moments follow their TP pieces, where JAX's at-rest spec leaves
# them whole until the first update moves them (mimm_tpu/parallel/mesh.py
# mi_state_specs: "follows its TP params on 1st update"), so JAX counts
# them replicated; and the critic's moments are its TP pieces sliced over
# 'data' by ZeRO-1, where JAX's spec slices the whole moments over 'data'
# alone (half the port's share a rank).
DIFFERENCES = {("tp_zero1", "txt_opt"): "text moments follow their TP "
                                        "pieces from the start",
               ("tp_zero1", "mi_opt"): "critic moments: TP pieces sliced "
                                       "over 'data'"}


def _reports(config_cls, bert_cls, report):
    out = {}
    for name, (trainer, kw) in CONFIGS.items():
        cfg = config_cls().replace(max_seq_length=16,
                                   compute_dtype="float32", **kw)
        out[name] = report(cfg, bert_config=bert_cls(**TINY_BERT)
                           if trainer == "mi" else None, trainer=trainer)
    return json.loads(json.dumps(out))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from mimm_tpu.config import TrainingConfig
    from mimm_tpu.models.bert import BertConfig
    from tests.torch_port_child import remove_job, start_child, finish_child

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from mem_report import report

    job = str(tmp_path_factory.mktemp("mem_report"))
    proc = start_child(__file__, job)
    want = _reports(TrainingConfig, BertConfig, report)
    _, got = finish_child(proc, job)
    yield want, got
    remove_job(job)


@pytest.mark.parametrize("name", CONFIGS)
def test_groups_match_jax(results, name):
    want, got = results
    w, g = want[name], got[name]
    assert g["mesh"] == w["mesh"] and g["trainer"] == w["trainer"]
    assert (g["zero1"], g["fsdp"]) == (w["zero1"], w["fsdp"])
    assert sorted(g["groups"]) == sorted(w["groups"])
    moved = 0.0
    for group, v in w["groups"].items():
        mine = g["groups"][group]
        assert mine["global_mb"] == v["global_mb"], group
        if (name, group) not in DIFFERENCES:
            assert mine["per_rank_mb"] == v["per_chip_mb"], group
        moved += v["per_chip_mb"] - mine["per_rank_mb"]
    assert g["total_global_mb"] == w["total_global_mb"]
    assert abs(g["total_per_rank_mb"] - (w["total_per_chip_mb"] - moved)) \
        <= 0.01


def test_named_differences(results):
    """What DIFFERENCES says, in numbers: JAX counts the text moments
    whole and the critic's moments halved; the port the text moments as
    its TP text parameters (Adam's two f32 moments a parameter) and the
    critic's at half JAX's share."""
    want, got = results
    w, g = want["tp_zero1"]["groups"], got["tp_zero1"]["groups"]
    assert w["txt_opt"]["per_chip_mb"] == w["txt_opt"]["global_mb"]
    assert g["txt_opt"]["per_rank_bytes"] == \
        2 * g["params/text_model"]["per_rank_bytes"] < \
        g["txt_opt"]["global_bytes"]
    assert abs(w["mi_opt"]["per_chip_mb"] - w["mi_opt"]["global_mb"] / 2) \
        <= 0.01
    assert abs(g["mi_opt"]["per_rank_mb"] - w["mi_opt"]["per_chip_mb"] / 2) \
        <= 0.01


@pytest.mark.parametrize("name", CONFIGS)
def test_bytes_round_to_the_mb(results, name):
    _, got = results
    for group, v in got[name]["groups"].items():
        assert round(v["global_bytes"] / 2 ** 20, 2) == v["global_mb"]
        assert round(v["per_rank_bytes"] / 2 ** 20, 2) == v["per_rank_mb"]
        assert v["per_rank_bytes"] <= v["global_bytes"], group


# ---- port side (jax-free child) ------------------------------------------

def _child(job):
    from mimm_tpu_torch.config import TrainingConfig
    from mimm_tpu_torch.models.bert import BertConfig
    from mimm_tpu_torch.tools.mem_report import report

    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(_reports(TrainingConfig, BertConfig, report), f)
    np.savez(os.path.join(job, "out.npz"))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    _child(sys.argv[1])
