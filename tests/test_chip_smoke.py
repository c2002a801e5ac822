"""The pieces of chip_smoke.py that run without a card: the seeded data,
the byte-identity check, the device check, the result line, and which
phases each mode runs.  The card-only phases run in chip_smoke.py
itself."""

import json
import os

import pytest

import chip_smoke


TINY = chip_smoke.Cohort("t", "CCCTAAA", 2, 5, 9_500, 0.5, ())


def test_generator_is_deterministic(tmp_path):
    a, b, c = tmp_path / "a", tmp_path / "b", tmp_path / "c"
    assert chip_smoke.generate(TINY, str(a), 3) == \
        chip_smoke.generate(TINY, str(b), 3)
    chip_smoke.generate(TINY, str(c), 4)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == TINY.files
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes()
    assert any((a / n).read_bytes() != (c / n).read_bytes() for n in names)


def _run_dir(d, agg_value="2110.00"):
    d.mkdir()
    (d / "telolengths_all.csv").write_bytes(
        b"file_number,phrase,trc,readID,telo_length\r\nx,5,0.900,r1,2110\r\n")
    (d / "x_trc_over_0.7.fastq").write_bytes(b"@r1\nACGT\n+\nIIII\n")
    (d / "topsicle_run.log").write_text(
        "[2026-01-01 00:00:00] begin processing reads\n"
        "[2026-01-01 00:00:01] k-mer: 5, with TRC >= 0.7, median telomere "
        f"length is {agg_value} bp\n"
        "[2026-01-01 00:00:01] asymptotic TRC, or recommended cutoff: 0.897\n")


def test_identical_outputs_pass(tmp_path):
    _run_dir(tmp_path / "a")
    _run_dir(tmp_path / "b")
    assert chip_smoke.compare_outputs(str(tmp_path / "a"),
                                      str(tmp_path / "b"), 1) == []


@pytest.mark.parametrize("name", ["telolengths_all.csv",
                                  "x_trc_over_0.7.fastq"])
def test_identity_check_catches_one_byte(tmp_path, name):
    _run_dir(tmp_path / "a")
    _run_dir(tmp_path / "b")
    p = tmp_path / "b" / name
    data = bytearray(p.read_bytes())
    data[-2] ^= 1
    p.write_bytes(bytes(data))
    assert chip_smoke.compare_outputs(str(tmp_path / "a"),
                                      str(tmp_path / "b"), 1) != []


def test_identity_check_catches_aggregate_line(tmp_path):
    _run_dir(tmp_path / "a")
    _run_dir(tmp_path / "b", agg_value="2111.00")
    diffs = chip_smoke.compare_outputs(str(tmp_path / "a"),
                                       str(tmp_path / "b"), 1)
    assert diffs == ["aggregate log lines"]


def test_identity_check_needs_every_phrase(tmp_path):
    _run_dir(tmp_path / "a")
    _run_dir(tmp_path / "b")
    assert chip_smoke.compare_outputs(str(tmp_path / "a"),
                                      str(tmp_path / "b"), 3) != []


@pytest.mark.parametrize("info,count", [
    ({"platform": "cpu", "kind": "cpu", "count": 8}, None),
    ({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}, 4),
])
def test_device_check_refuses(info, count):
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_device(info, count)


def test_device_check_accepts_gpu():
    chip_smoke.check_device({"platform": "gpu", "kind": "x", "count": 4}, 4)


def test_contract_line_shape():
    info = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
            "jax": "0.9.0"}
    line = chip_smoke.contract_line(info)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


@pytest.mark.parametrize("four_cards", [False, True])
def test_main_runs_only_its_phases(monkeypatch, capsys, tmp_path, four_cards):
    """--four-cards runs the four-card phase and nothing else; the
    default runs phases 1-4 on one card.  Both end on the result line."""
    count = 4 if four_cards else 1
    info = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
            "count": count, "jax": "0.9.0"}
    ran = []
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path / ".chip_smoke"))
    monkeypatch.setattr(chip_smoke, "nvidia_smi",
                        lambda: ["NVIDIA H100 80GB HBM3, 700.00 W"] * count)
    monkeypatch.setattr(chip_smoke, "probe_devices", lambda kids: info)
    monkeypatch.setattr(chip_smoke, "run_four_cards",
                        lambda kids, work, seed: ran.append("four_cards"))
    monkeypatch.setattr(
        chip_smoke, "run_single_card",
        lambda kids, work, seed: ran.extend(["a_cold", "a_warm", "oracle"])
        or {"warm_wall_s": 1.0, "reads": 128})
    monkeypatch.setattr(
        chip_smoke, "kernel_decision",
        lambda seed, wall, reads: ran.append("kernel") or info)
    argv = ["--four-cards"] if four_cards else []
    assert chip_smoke.main(argv) == 0
    assert ran == chip_smoke.phases(four_cards)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["device"]["count"] == count
    assert lines[-2].startswith("card: NVIDIA H100")


def test_main_fails_without_gpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path / ".chip_smoke"))
    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda: ["some card, 1 W"])
    monkeypatch.setattr(chip_smoke, "probe_devices", lambda kids: {
        "platform": "cpu", "kind": "cpu", "count": 1, "jax": "0.9.0"})
    monkeypatch.setattr(chip_smoke, "run_single_card", lambda *a: pytest.fail(
        "no phase may run without a GPU"))
    assert chip_smoke.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out
