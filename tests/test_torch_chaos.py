"""Chaos/soak coverage of the port's supervised service and fleet, at the
JAX package's tier-1 sizes (``tests/test_chaos.py``), on the CPU.

``semantic_merge_tpu_torch.scripts.chaos_soak`` drives ``python -m
semantic_merge_tpu_torch serve --supervise --device cpu`` and ``fleet
--device cpu`` with the JAX soak's traffic (clean, degrade-scan,
degrade-apply, strict-scan and resolve merges, one idempotency key per
request across its attempts) and its kill, partition and churn
schedules, and checks the JAX soak's invariants: byte-exact settled
trees with no journal or lock debris, documented exit codes only,
respawns observable, RSS under the watermark, and, for the fleet, the
WAL's exactly-once accounting. The port's ladder has no CPU rung: the
breaker the fault traffic trips is the ``torch`` rung's, where the JAX
soak's is the ``host`` rung's.

The WAL audit keeps every check of the JAX audit and tolerates one
difference between a key's journaled payloads, ``params.trace_id`` (a
resend reaching a restarted router gets a fresh trace id; a member's
idempotency cache is keyed on ``idempotency_key``, so it is no
duplicate effect), counted in the report, never hidden: the unit cases
below hold the audit against the JAX one on synthetic journals.

The slow-marked soaks triple the traffic and kill counts, as in JAX.
"""
import json
import os

import pytest

from semantic_merge_tpu.fleet import wal as jax_wal
from semantic_merge_tpu_torch.fleet import wal
from semantic_merge_tpu_torch.scripts import chaos_soak

_JAX_SOAK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "scripts", "chaos_soak.py")


def _jax_audit(wal_dir):
    import importlib.util
    spec = importlib.util.spec_from_file_location("jax_chaos_soak", _JAX_SOAK)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.audit_wal(wal_dir)


def _check_report(report, *, requests, kills):
    assert report["errors"] == [], "\n".join(report["errors"])
    assert report["ok"] is True
    total = sum(sum(per_code.values()) for per_code in report["outcomes"].values())
    assert total == requests
    assert set(report["outcomes"]) == {
        "clean", "degrade-scan", "degrade-apply", "strict-scan", "resolve"}
    assert set(report["outcomes"]["resolve"]) <= {"0", "1"}
    assert report["resolutions_total"] is not None
    assert report["resolutions_total"] >= 1
    assert report["kills"] == kills
    assert report["daemon_pids_seen"] >= 2
    assert report["supervisor_restarts"] >= 1
    assert report["transport_retries"] >= 1
    assert report["final_rss_mb"] < 4096.0


def test_chaos_smoke(tmp_path):
    report = chaos_soak.run_soak(
        tmp_path / "soak", requests=200, repos=8, concurrency=8,
        kills=2, seed=1, hard_mb=4096.0, device="cpu")
    _check_report(report, requests=200, kills=2)
    # The fault traffic keeps failing the port's semantic rung (torch),
    # so its breaker tripped in the surviving daemon's lifetime.
    assert report["breaker_transitions"] is not None
    assert report["breaker_transitions"] >= 1
    assert report["breakers"] is not None
    assert "torch" in report["breaker_rungs"] and "host" not in report["breaker_rungs"]


@pytest.mark.slow
def test_chaos_full_soak(tmp_path):
    report = chaos_soak.run_soak(
        tmp_path / "soak", requests=600, repos=12, concurrency=12,
        kills=5, seed=7, hard_mb=4096.0, device="cpu")
    _check_report(report, requests=600, kills=5)
    assert report["breaker_transitions"] >= 1


def _check_fleet(report, *, requests):
    assert report["errors"] == [], "\n".join(report["errors"])
    assert report["ok"] is True
    total = sum(sum(per_code.values()) for per_code in report["outcomes"].values())
    assert total == requests
    assert report["wal_open"] == 0
    assert isinstance(report["wal_trace_only_keys"], int)


def test_fleet_chaos_smoke(tmp_path):
    """Three supervised members and one TCP member on the CPU, one member
    SIGKILL and one router SIGKILL mid-stream, one elastic join and one
    drain, one SIGSTOP partition of the TCP member."""
    report = chaos_soak.run_fleet_soak(
        tmp_path / "fleet", requests=24, repos=4, concurrency=4,
        members=3, member_kills=1, router_kills=1, seed=3,
        tcp_members=1, partitions=1, churn=True, device="cpu")
    _check_fleet(report, requests=24)
    assert report["member_kills"] == 1
    assert report["router_kills"] == 1
    assert report["failovers_total"] >= 1
    assert report["router_pids_seen"] >= 2
    assert report["members_up"] == 4
    assert report["partitions"] == 1
    assert report["partition_failovers"] >= 1
    assert report["churn_joins"] == 1
    assert report["churn_drains"] == 1
    assert report["drain_failovers"] >= 1
    assert report["joins_total"] >= 2


@pytest.mark.slow
def test_fleet_chaos_full_drill(tmp_path):
    report = chaos_soak.run_fleet_soak(
        tmp_path / "fleet", requests=120, repos=8, concurrency=8,
        members=3, member_kills=3, router_kills=2, seed=11,
        tcp_members=2, partitions=2, churn=True, device="cpu")
    _check_fleet(report, requests=120)
    assert report["member_kills"] == 3
    assert report["router_kills"] == 2
    assert report["failovers_total"] >= 3
    assert report["partitions"] == 2
    assert report["partition_failovers"] >= 1


def test_cli_entrypoint_smoke(tmp_path, capsys):
    rc = chaos_soak.main(["--requests", "8", "--repos", "2", "--concurrency", "2",
                          "--kills", "0", "--device", "cpu",
                          "--workdir", str(tmp_path / "mini")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "OK" in out


# --- the WAL audit on synthetic journals -------------------------------------------

_PARAMS = {"argv": ["basebr", "brA", "brB", "--inplace"], "cwd": "/r", "env": {},
           "idempotency_key": "k1", "trace_id": "t-first"}


def _journal(tmp_path, records):
    directory = tmp_path / "wal"
    directory.mkdir()
    with open(directory / wal.WAL_FILE, "w") as fh:
        for rec in records:
            fh.write(json.dumps(rec, sort_keys=True) + "\n")
    return str(directory)


def _request(key, **params):
    merged = dict(_PARAMS, idempotency_key=key, **params)
    return {"kind": "request", "key": key, "verb": "semmerge", "params": merged,
            "trace_id": merged["trace_id"], "t": 1.0}


def test_wal_file_format_is_the_jax_one():
    assert wal.WAL_FILE == jax_wal.WAL_FILE and wal.RECORD_KINDS == jax_wal.RECORD_KINDS


def test_audit_passes_a_clean_journal_as_the_jax_audit(tmp_path):
    d = _journal(tmp_path, [_request("k1"), {"kind": "dispatch", "key": "k1", "member": "m0"},
                            {"kind": "ack", "key": "k1"}])
    assert chaos_soak.audit_wal(d) == ([], [])
    assert _jax_audit(d) == []


def test_audit_counts_a_trace_id_only_resend(tmp_path):
    """The known quirk: the JAX audit fails it, the port's counts it."""
    d = _journal(tmp_path, [_request("k1"), _request("k1", trace_id="t-minted-anew"),
                            {"kind": "ack", "key": "k1"}, {"kind": "ack", "key": "k1"}])
    errors, trace_only = chaos_soak.audit_wal(d)
    assert errors == [] and trace_only == ["k1"]
    jax_errors = _jax_audit(d)
    assert len(jax_errors) == 1 and "2 different payloads" in jax_errors[0]


@pytest.mark.parametrize("field", ["argv", "env", "cwd"])
def test_audit_fails_any_other_payload_difference(tmp_path, field):
    other = {"argv": ["basebr", "brA", "brC", "--inplace"], "env": {"SEMMERGE_FAULT": "x"},
             "cwd": "/elsewhere"}[field]
    d = _journal(tmp_path, [_request("k1"), _request("k1", trace_id="t2", **{field: other})])
    errors, trace_only = chaos_soak.audit_wal(d)
    assert trace_only == []
    assert len(errors) == 1 and "duplicate-effect hazard" in errors[0]
    assert f"params.{field}" in errors[0] and "params.trace_id" in errors[0]
    assert len(_jax_audit(d)) == 1


def test_audit_keeps_the_jax_exactly_once_checks(tmp_path):
    d = _journal(tmp_path, [
        _request("k1"), {"kind": "ack", "key": "k1"}, {"kind": "ack", "key": "k1"},
        {"kind": "dispatch", "key": "ghost", "member": "m0"},
        {"kind": "teleport", "key": "k1"}, {"kind": "ack", "key": ""}])
    errors, _ = chaos_soak.audit_wal(d)
    assert sorted(errors) == sorted(_jax_audit(d))
    text = "\n".join(errors)
    assert "undocumented record kind 'teleport'" in text
    assert "ack record without a key" in text
    assert "key ghost dispatched/acked but never journaled" in text
    assert "key k1 acked 2x for 1 journaled incarnation(s)" in text
    empty = tmp_path / "empty"
    empty.mkdir()
    assert chaos_soak.audit_wal(str(empty))[0] == [f"wal: no records found under {empty}"]


def test_payload_diff_names_the_fields():
    a = {"verb": "semmerge", "params": {"x": 1, "y": {"z": 2}}}
    assert chaos_soak.payload_diff(a, a) == []
    b = {"verb": "semmerge", "params": {"x": 1, "y": {"z": 3}, "w": 0}}
    assert chaos_soak.payload_diff(a, b) == ["params.w", "params.y.z"]
