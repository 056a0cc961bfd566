"""The port's encoder throughput sweep (sat_tpu_torch.evalx.encoder_sweep)
against sat_tpu.evalx.encoder_sweep on the CPU: parameter counts, the
rows' keys and shapes, and the printed line with the timing fields
masked."""

import re

import jax
import jax.numpy as jnp
import pytest

from sat_tpu.evalx import encoder_sweep as JS
from sat_tpu.models.encoder import SATEncoder as JaxEncoder
from sat_tpu_torch.config import SATConfig
from sat_tpu_torch.evalx import encoder_sweep as TS
from sat_tpu_torch.models.encoder import encoder_from_config
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TIMED = ("latency_ms", "batches_per_sec", "imgs_per_sec")


@pytest.mark.parametrize("arch,dim", [("squeezenet1_1", None), ("densenet121", None),
                                      ("mobilenet_v3_small", 256)])
def test_count_params_matches_jax(arch, dim):
    """The encoder's parameters (the proj included where encoder_dim asks
    for one), not its running statistics, as JAX counts its params tree."""
    import torch
    with torch.device("meta"):
        enc = encoder_from_config(SATConfig(encoder_arch=arch, input_size=224,
                                            encoder_dim=dim))
    module = JaxEncoder(arch=arch, encoder_dim=dim)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 224, 224, 3))))
    assert TS.count_params(enc) == JS.count_params(shapes["params"]) > 0


def masked(line):
    return re.sub(r"(Latency|Batches/s|Imgs/s)=\s*(-?\d+\.\d+|-?inf|nan)", r"\1=#", line)


@pytest.mark.parametrize("precision", [32, 16])
def test_sweep_rows_and_lines_match_jax(precision, capsys):
    """A tiny sweep (input 32, batch 2): JAX's row keys, features,
    attention and params; finite positive rates; the printed lines equal
    JAX's with the three timing fields masked."""
    archs = ["squeezenet1_1", "shufflenet_v2_x0_5"]
    want = JS.sweep(archs, batch=2, input_size=32, precision=precision)
    jax_out = capsys.readouterr().out
    got = TS.sweep(archs, batch=2, input_size=32, precision=precision, device="cpu")
    port_out = capsys.readouterr().out
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert {k: g[k] for k in g if k not in TIMED} == {k: w[k] for k in w if k not in TIMED}
        assert all(0 < g[k] < float("inf") for k in TIMED)
    lines = port_out.splitlines()
    assert len(lines) == len(archs)
    assert [masked(x) for x in lines] == [masked(x) for x in jax_out.splitlines()]
    assert masked(lines[0]) == (
        f"arch=squeezenet1_1      features= 512 attention=  1 params=  0.72M. "
        f"bf16={str(precision == 16):5} Latency=# ms. batch=   2. Batches/s=#. Imgs/s=#.")


def test_main_prints_the_rows(capsys):
    """``main`` with the CLI's flags, on the CPU."""
    rows = TS.main(["--archs", "squeezenet1_1", "--batch", "1", "--input_size", "32",
                    "--precision", "32", "--encoder_dim", "64"], device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert len(rows) == len(out) == 1
    assert rows[0]["features"] == 64 and rows[0]["batch"] == 1
    assert out[0].startswith("arch=squeezenet1_1      features=  64 attention=  1 ")
    assert " bf16=False Latency=" in out[0]


def test_no_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.main(["--archs", "squeezenet1_1", "--input_size", "32"])
