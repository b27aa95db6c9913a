"""The cases of ``tests/test_native.py`` on the port, on the CPU.

A translated copy of that file: the same classes, functions,
parametrisations and asserts, run on ``wdbx_tpu_torch``. Each
``wdbx_tpu`` import names its ``wdbx_tpu_torch`` counterpart; the
autouse fixture asks for the CPU through
``test_torch_ops.port_on_cpu`` (the default device and mesh of one
test), so the package keeps the card as its own default.

Translated, every case (9 cases):
TestSlotRegistry: test_assign_fresh_and_existing, test_put_and_lookup,
test_put_overwrite, test_remove_and_reuse,
test_items_state_load_roundtrip, test_unicode_ids;
test_native_is_used_by_default; test_id_table_both_impls;
test_registry_rejects_invalid_inputs.

Changed beyond the imports and the fixture: nothing. Left out: nothing.
As in the reference, the cases of the built C++ registry skip where
the port's extension (``wdbx_tpu_torch/native``) is not built.

The reference file's description:

Native slot registry tests — both the C++ extension (if built) and
the pure-Python fallback must satisfy the same contract.
"""

import pytest

from wdbx_tpu_torch.native import HAVE_NATIVE, PySlotRegistry, SlotRegistry
from test_torch_ops import port_on_cpu


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    port_on_cpu(monkeypatch)

IMPLS = [PySlotRegistry]
if HAVE_NATIVE:
    IMPLS.append(SlotRegistry)


@pytest.fixture(params=IMPLS, ids=lambda c: c.__name__)
def registry(request):
    return request.param()


class TestSlotRegistry:
    def test_assign_fresh_and_existing(self, registry):
        slots, fresh = registry.assign(["a", "b", "a"])
        assert slots[0] == slots[2]
        assert fresh == [True, True, False]
        assert registry.size() == 2

    def test_put_and_lookup(self, registry):
        registry.put(["x", "y"], [10, 20])
        assert registry.lookup("x") == 10
        assert registry.id_of(20) == "y"
        assert registry.lookup("z") is None
        assert registry.id_of(99) is None
        assert registry.contains("x") and not registry.contains("z")

    def test_put_overwrite(self, registry):
        registry.put(["x"], [1])
        registry.put(["x"], [2])
        assert registry.lookup("x") == 2

    def test_remove_and_reuse(self, registry):
        slots, _ = registry.assign(["a", "b"])
        assert registry.remove("a") == slots[0]
        assert registry.remove("a") is None
        assert registry.lookup("a") is None
        assert registry.id_of(slots[0]) is None
        new_slots, _ = registry.assign(["c"])
        assert new_slots[0] == slots[0]  # freed slot recycled

    def test_items_state_load_roundtrip(self, registry):
        registry.assign(["a", "b", "c"])
        registry.remove("b")
        items = registry.items()
        next_slot, free = registry.state()
        other = type(registry)()
        other.load(items, next_slot, free)
        assert sorted(other.items()) == sorted(items)
        assert other.lookup("a") == registry.lookup("a")
        # freed slot survives the round trip
        s, _ = other.assign(["d"])
        assert s[0] == 1

    def test_unicode_ids(self, registry):
        registry.put(["ключ-😀"], [5])
        assert registry.lookup("ключ-😀") == 5
        assert registry.id_of(5) == "ключ-😀"


@pytest.mark.skipif(not HAVE_NATIVE, reason="native extension not built")
def test_native_is_used_by_default():
    from wdbx_tpu_torch.native import SlotRegistry as Default

    assert Default.__module__ == "_native"


def test_id_table_both_impls():
    """id_table() must agree between the native and Python registries:
    slot-indexed ids with None holes after removals."""
    from wdbx_tpu_torch.native import PySlotRegistry, SlotRegistry

    for cls in {PySlotRegistry, SlotRegistry}:
        reg = cls()
        reg.put(["a", "b", "c"], [0, 1, 2])
        reg.remove("b")
        table = reg.id_table()
        assert list(table) == ["a", None, "c"], (cls, table)


def test_registry_rejects_invalid_inputs():
    """Both implementations refuse negative slots and empty ids (the
    native extension previously wrote out of bounds / aborted; the
    empty string collides with its unused-slot sentinel)."""
    import pytest

    from wdbx_tpu_torch.native import PySlotRegistry, SlotRegistry

    for cls in {SlotRegistry, PySlotRegistry}:
        reg = cls()
        with pytest.raises(ValueError):
            reg.put(["a"], [-1])
        with pytest.raises(ValueError):
            reg.put([""], [0])
        reg.put(["ok"], [3])
        assert reg.lookup("ok") == 3
