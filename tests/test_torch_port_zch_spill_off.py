"""The ZCH DeepFM of test_torch_port_zch_spill.py with the dynamicemb
host spill tier turned off (``TZREC_HOST_SPILL=0``) in both packages:
an evicted key's row is dropped and its slot's row goes to the new key
as it stands. 8 steps of ``train_and_evaluate`` from the same weights:
ZCH mappings exactly equal, tables and row state within 1e-5 and dense
parameters within 1e-4 of each tensor's max, and no spill store in the
port's checkpoint."""

from test_torch_port_zch_spill import _assert_port_matches_jax, _train_both


def test_spill_tier_off_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("TZREC_HOST_SPILL", "0")
    steps = 8
    ck = _assert_port_matches_jax(_train_both(str(tmp_path), steps), steps)
    assert "zch_spill" not in ck
