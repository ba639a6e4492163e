"""The port's ``repro_torch.sync`` registry: twins of the registry tests of
``tests/test_sync_api.py``, run against the port's own registry, and the
port's builtins against the JAX package's."""

import dataclasses

import pytest

from repro.sync import available_policies as jax_available_policies
from repro.sync import get_policy as jax_get_policy
from repro_torch.sync import (
    LAYER_HOOKS,
    SyncPolicy,
    available_policies,
    canonical_name,
    get_policy,
    register_policy,
    unregister_policy,
)

BUILTINS = ("scu", "tas", "sw", "tree", "tree4", "tree_ew", "fifo")


def test_builtins_registered_in_order():
    assert available_policies() == BUILTINS


def test_builtins_equal_the_jax_packages():
    assert available_policies() == jax_available_policies()
    for name in BUILTINS:
        ours, theirs = get_policy(name), jax_get_policy(name)
        assert ours.aliases == theirs.aliases
        for hook in ("make_pipeline_programs", "make_work_queue_programs", "trace_barrier", "trace_mutex"):
            assert (getattr(ours, hook) is None) == (getattr(theirs, hook) is None), (name, hook)
        assert ours.trace_safe_barrier == theirs.trace_safe_barrier
        assert ours.trace_safe_mutex == theirs.trace_safe_mutex


def test_the_registries_are_separate():
    policy = _dummy_policy()
    try:
        register_policy(policy)
        assert "dummy" in available_policies()
        assert "dummy" not in jax_available_policies()
    finally:
        unregister_policy("dummy")


def _dummy_policy(name="dummy"):
    scu = get_policy("scu")
    return dataclasses.replace(scu, name=name, aliases=(name.upper(),))


def test_register_resolve_list_roundtrip():
    policy = _dummy_policy()
    try:
        register_policy(policy)
        assert "dummy" in available_policies()
        assert get_policy("dummy") is policy
        assert get_policy("DUMMY") is policy  # alias + case-insensitivity
        assert canonical_name("Dummy") == "dummy"
    finally:
        unregister_policy("dummy")
    assert "dummy" not in available_policies()


def test_double_registration_rejected():
    policy = _dummy_policy()
    try:
        register_policy(policy)
        with pytest.raises(ValueError, match="already registered"):
            register_policy(policy)
        register_policy(policy, overwrite=True)  # explicit overwrite allowed
    finally:
        unregister_policy("dummy")


def test_alias_cannot_hijack_existing_policy():
    hijacker = dataclasses.replace(_dummy_policy("ring"), aliases=("scu",))
    with pytest.raises(ValueError, match="collides"):
        register_policy(hijacker)
    legacy_hijacker = dataclasses.replace(_dummy_policy("ring"), aliases=("SW",))
    with pytest.raises(ValueError, match="collides"):
        register_policy(legacy_hijacker)
    assert get_policy("scu").name == "scu"
    assert "ring" not in available_policies()


def test_overwrite_drops_stale_aliases():
    policy = dataclasses.replace(_dummy_policy(), aliases=("DUMMY", "DMY"))
    try:
        register_policy(policy)
        replacement = dataclasses.replace(policy, aliases=("DUMMY",))
        register_policy(replacement, overwrite=True)
        assert get_policy("dummy") is replacement
        with pytest.raises(KeyError):
            get_policy("dmy")  # stale alias of the replaced policy is gone
    finally:
        unregister_policy("dummy")


def test_unknown_policy_error_names_available():
    with pytest.raises(KeyError) as e:
        get_policy("bogus")
    msg = str(e.value)
    for name in BUILTINS:
        assert name in msg, f"error should name available policy {name!r}: {msg}"
    with pytest.raises(KeyError) as e_jax:
        jax_get_policy("bogus")
    assert msg == str(e_jax.value)  # the same error text


def test_incomplete_policy_rejected():
    incomplete = dataclasses.replace(_dummy_policy("broken"), chip_barrier=None)
    with pytest.raises(TypeError, match="chip_barrier"):
        register_policy(incomplete)


def test_legacy_spellings_resolve():
    for legacy in ("SCU", "TAS", "SW", "TREE", "TREE4", "TREE_EW", "FIFO"):
        assert get_policy(legacy).name == legacy.lower()


@pytest.mark.parametrize("name", BUILTINS)
def test_policy_implements_protocol(name):
    policy = get_policy(name)
    assert isinstance(policy, SyncPolicy)
    for hook in LAYER_HOOKS:
        assert callable(getattr(policy, hook)), f"{name} missing {hook}"
    assert policy.description


def test_config_base_choices_track_registry():
    from repro_torch.configs.base import sync_policy_choices, validate_sync_policy

    assert sync_policy_choices() == available_policies()
    assert validate_sync_policy("SW") == "sw"
    with pytest.raises(KeyError, match="available policies"):
        validate_sync_policy("bogus")
