"""The port's bench regression sentinel (``observability/regression.py``,
a stdlib copy of the reference's, loaded here by file path as the
reference's test loads its own): the rule engine's oracles, the same
verdicts as the reference's module on the committed ``bench_full.json``
and on regressed copies of it, and kerneldiff's ``--out``/``--baseline``
on the CPU (the plain versions), which refuse ``kernel_trust.json``."""

import copy
import importlib.util
import json
import os

import pytest

from deeplearning4j_tpu.observability import regression as jax_reg
from deeplearning4j_tpu_torch.observability import kerneldiff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "bench_full.json")


def _load_module():
    spec = importlib.util.spec_from_file_location(
        "_torch_reg_under_test",
        os.path.join(REPO, "deeplearning4j_tpu_torch", "observability",
                     "regression.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


reg = _load_module()


def _committed():
    with open(COMMITTED) as f:
        return json.load(f)


# ----------------------------------------------------------- rule engine
def test_direction_and_tolerance():
    base = {"all": [{"metric": "Tput (x)", "value": 100.0},
                    {"metric": "Lat (x)", "value": 10.0}]}
    worse = {"all": [{"metric": "Tput (x)", "value": 70.0},
                     {"metric": "Lat (x)", "value": 13.0}]}
    rules = [reg.Rule("Tput", tolerance=0.2),
             reg.Rule("Lat", direction=reg.LOWER, tolerance=0.2)]
    rep = reg.compare(base, worse, rules)
    assert [v.status for v in rep.verdicts] == ["regressed", "regressed"]
    assert rep.exit_code == 1
    within = {"all": [{"metric": "Tput (x)", "value": 85.0},
                      {"metric": "Lat (x)", "value": 11.0}]}
    assert reg.compare(base, within, rules).exit_code == 0


def test_missing_and_no_baseline():
    base = {"all": [{"metric": "Tput (x)", "value": 100.0}]}
    rep = reg.compare(base, {"all": []}, [reg.Rule("Tput")])
    assert rep.verdicts[0].status == "regressed"   # required by default
    rep = reg.compare(base, {"all": []},
                      [reg.Rule("Tput", required=False)])
    assert rep.verdicts[0].status == "missing" and rep.exit_code == 0
    rep = reg.compare({"all": []}, base, [reg.Rule("Tput")])
    assert rep.verdicts[0].status == "no_baseline" and rep.exit_code == 0


def test_dotted_field_and_rule_roundtrip():
    base = {"all": [{"metric": "D (x)", "value": 1.0,
                     "variants": {"v": {"tps": 50.0}}}]}
    fresh = copy.deepcopy(base)
    fresh["all"][0]["variants"]["v"]["tps"] = 10.0
    rule = reg.Rule("D", field="variants.v.tps", tolerance=0.3)
    assert reg.compare(base, fresh, [rule]).exit_code == 1
    assert reg.Rule.from_dict(rule.to_dict()).to_dict() == rule.to_dict()
    with pytest.raises(ValueError):
        reg.Rule("x", direction="sideways")
    with pytest.raises(ValueError):
        reg.Rule.from_dict({"metric": "x", "bogus": 1})


def test_default_rules_cover_committed_bench():
    doc = _committed()
    for rule in reg.DEFAULT_RULES:
        if rule.required:
            assert reg.extract(doc, rule) is not None, rule.key


# ------------------------------------------------ same verdicts as the JAX
def _verdicts(mod, base, fresh):
    rep = mod.compare(base, fresh)
    return ([(v.rule.key, v.status) for v in rep.verdicts], rep.exit_code)


def _degraded(scale_decode=0.4, scale_lat=None):
    doc = _committed()
    for entry in doc["all"]:
        if entry["metric"].startswith("Decode tokens/sec"):
            entry["value"] = entry["value"] * scale_decode
    if scale_lat is not None:
        for entry in doc["all"]:
            if "latency" in entry["metric"].lower() and isinstance(
                    entry.get("value"), (int, float)):
                entry["value"] = entry["value"] * scale_lat
    return doc


@pytest.mark.parametrize("case", ["committed", "decode_down", "all_down"])
def test_same_verdicts_as_the_reference(case):
    """The port's copy and the reference's module judge the committed
    document and synthetically regressed copies of it identically."""
    base = _committed()
    fresh = {"committed": _committed,
             "decode_down": _degraded,
             "all_down": lambda: _degraded(0.1, 3.0)}[case]()
    ours, theirs = _verdicts(reg, base, fresh), _verdicts(jax_reg, base,
                                                          fresh)
    assert ours == theirs
    assert ours[1] == (0 if case == "committed" else 1)
    if case != "committed":
        assert any(k.startswith("Decode tokens/sec") and s == "regressed"
                   for k, s in ours[0])


def test_check_files_zero_then_nonzero(tmp_path):
    fresh = tmp_path / "bench_full.json"
    fresh.write_text(json.dumps(_committed()))
    assert reg.check_files(COMMITTED, str(fresh)).exit_code == 0
    fresh.write_text(json.dumps(_degraded()))
    rep = reg.check_files(COMMITTED, str(fresh))
    assert rep.exit_code == 1 and "REGRESSED" in rep.format()


# ---------------------------------------------------- kerneldiff baseline
def test_kernel_trust_rules_name_the_ports_kernels():
    names = {r.metric[len("Kernel max rel error ("):-1]
             for r in reg.KERNEL_TRUST_RULES if r.scope == "all"}
    assert names == set(kerneldiff.KERNELS)


def test_kerneldiff_out_then_baseline_on_the_cpu(tmp_path, capsys):
    """``--out`` writes the CPU sweep's report, ``--baseline`` against it
    exits 0, and a baseline doctored to tighten one kernel's max-rel ten
    times exits 1 naming it."""
    out = tmp_path / "trust.json"
    args = ["--kernels", "lrn_fwd", "--device", "cpu"]
    assert kerneldiff.main(args + ["--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["platform"] == "cpu" and "lrn_fwd" in report["kernels"]
    assert kerneldiff.main(args + ["--baseline", str(out)]) == 0
    doctored = json.loads(out.read_text())
    entry = next(e for e in doctored["all"]
                 if e["metric"] == "Kernel max rel error (lrn_fwd)")
    assert entry["value"] > 0
    entry["value"] /= 10.0
    tight = tmp_path / "tight.json"
    tight.write_text(json.dumps(doctored))
    capsys.readouterr()
    assert kerneldiff.main(args + ["--baseline", str(tight)]) == 1
    assert "REGRESSED" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--out", "--baseline"])
def test_kerneldiff_refuses_kernel_trust_json(tmp_path, flag):
    with pytest.raises(SystemExit) as e:
        kerneldiff.main(["--device", "cpu", "--kernels", "lrn_fwd", flag,
                         str(tmp_path / "kernel_trust.json")])
    assert e.value.code == 2
    assert not (tmp_path / "kernel_trust.json").exists()
