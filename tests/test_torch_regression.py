"""``bench --mode all`` in the port (gdkvm_tpu_torch/eval/regression.py): the
smoke artifact on the CPU is complete and valid with real numbers in every
section but the card's kernel row, shape flags are refused, errored
sections are named (nested arms too) and make the command exit 1 outside
``--smoke`` (mirroring tests/test_bench_contract.py).
"""

import contextlib
import io
import json

import pytest
import torch

from gdkvm_tpu_torch.cli import main
from gdkvm_tpu_torch.eval import regression

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def smoke_artifact(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bench") / "bench_all.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["bench", "--mode", "all", "--smoke", "--device", "cpu", "--out", out])
    assert rc == 0
    with open(out) as f:
        artifact = json.load(f)
    assert json.loads(buf.getvalue().strip().splitlines()[-1]) == artifact
    return artifact


def test_smoke_artifact_is_valid_and_complete(smoke_artifact):
    art = smoke_artifact
    regression.validate_artifact(art)
    assert art["schema"] == regression.SCHEMA_VERSION != "gdkvm-bench-all/v2"
    assert regression.failed_sections(art) == []
    assert (art["platform"], art["device"], art["smoke"]) == ("cpu", "cpu", True)
    assert "skipped" in art["sections"]["gdr_kernel_ab"]        # needs a card
    for name in regression.ARMED_SECTIONS:
        assert set(art["sections"][name]) == set(regression.ARMS), name


@pytest.mark.parametrize("arm", regression.ARMS)
def test_smoke_artifact_measures_each_arm(smoke_artifact, arm):
    secs = smoke_artifact["sections"]
    assert secs["serve_112"][arm]["frames_per_sec"] > 0
    for name in ("serve_112", "serve_256"):          # the streaming sections
        sec = secs[name][arm]
        assert sec["apparent_tflops"] > 0 and sec["plausible"] is None, (name, sec)
    assert secs["serve_256"][arm]["image_size"] == 48
    assert secs["train_step"][arm]["steps_per_sec"] > 0
    qa = secs["quant_ab"][arm]["tiny"]
    assert qa["fwd_ms_w8a8"] > 0 and len(qa["pairs_raw_ms"]) == 2
    assert qa["n_convs_w8a8"] > 0 and qa["peak_mb_w8a8"] is None      # no card
    qd = secs["serve_bench"][arm]["queue_decomposition"]
    assert qd["pieces"] > 0 and qd["service_ms_p50"] > 0
    host = secs["serve_bench"][arm]["host_profile"]
    assert host["device_tick_ms"] > 0 and host["http_roundtrip_ms"] > 0


@pytest.mark.parametrize("bad", [["--chunk", "8"], ["--batch", "2"], ["--image-size", "64"],
                                 ["--config", "x.yaml"], ["--grad"], ["model.num_heads=2"]],
                         ids=lambda b: b[0])
def test_bench_all_refuses_shape_flags(bad):
    with pytest.raises(SystemExit) as exc:
        main(["bench", "--mode", "all", "--smoke", "--device", "cpu", *bad])
    assert exc.value.code == 2


def test_failed_sections_names_errors_and_nested_arms():
    art = {"sections": {
        "ok": {"frames_per_sec": 1.0},
        "skipped": {"skipped": "needs a card"},
        "broken": {"error": "RuntimeError: boom"},
        "armed": {"flagship": {"x": 1}, "ts8": {"error": "boom"}},
    }}
    assert regression.failed_sections(art) == ["broken", "armed.ts8"]


def test_validate_artifact_checks_the_kernel_row(smoke_artifact):
    art = json.loads(json.dumps(smoke_artifact))
    row = {"kernel_ms": 0.2, "chunked_ms": 1.2, "speedup": 6.0,
           "pairs_raw_ms": [[0.2, 1.2], [0.21, 1.3]]}
    art["sections"]["gdr_kernel_ab"] = {"saturated_112": row}
    regression.validate_artifact(art)
    art["sections"]["gdr_kernel_ab"] = {"saturated_112": dict(row, kernel_ms=0.0)}
    with pytest.raises(AssertionError):
        regression.validate_artifact(art)
    with pytest.raises(AssertionError):
        regression.validate_artifact(dict(smoke_artifact, schema="gdkvm-bench-all/v2"))


@pytest.mark.parametrize("key", ["apparent_tflops", "plausible"])
def test_validate_artifact_wants_the_plausibility_keys(smoke_artifact, key):
    """A streaming section without the apparent TFLOP/s or ``plausible``
    (JAX's keys, gdkvm_tpu/eval/regression.py) fails validation."""
    art = json.loads(json.dumps(smoke_artifact))
    del art["sections"]["serve_256"]["ts8"][key]
    with pytest.raises(AssertionError):
        regression.validate_artifact(art)


@pytest.mark.parametrize("smoke,rc", [(True, 0), (False, 1)], ids=["smoke", "full"])
def test_an_errored_section_fails_the_command_outside_smoke(smoke_artifact, monkeypatch,
                                                            tmp_path, smoke, rc):
    art = json.loads(json.dumps(smoke_artifact))
    art["sections"]["quant_ab"]["ts8"] = {"error": "RuntimeError: boom"}
    monkeypatch.setattr(regression, "bench_all", lambda device, smoke=False: art)
    argv = ["bench", "--mode", "all", "--device", "cpu", "--out", str(tmp_path / "a.json")]
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(argv + (["--smoke"] if smoke else [])) == rc
