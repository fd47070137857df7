"""Port parity of the deprecated ``core/hardware`` shim (the twin of
``tests/test_hardware_shim.py``): each access warns and resolves to the very
object ``repro_torch.cost.shift_add`` holds, the Table VI / Fig. 5 values
unchanged and equal to the JAX package's, and importing ``repro_torch.core``
alone stays silent."""
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core import hardware as jhardware
from repro.core.policy import BitPolicy as JBitPolicy
from repro_torch.core.policy import BitPolicy, LayerInfo
from repro_torch.cost import shift_add

ROOT = Path(__file__).resolve().parents[1]


def _layers():
    return (LayerInfo("a", (64, 32), macs=2048),
            LayerInfo("b", (32, 32), macs=1024))


class TestDeprecationWarning:
    def test_access_warns(self):
        from repro_torch.core import hardware

        with pytest.warns(DeprecationWarning, match="repro_torch.cost.shift_add"):
            _ = hardware.AREA_UM2

    def test_import_of_core_stays_silent(self):
        """Importing the package must not warn; only *using* the shim does."""
        out = subprocess.run(
            [sys.executable, "-W", "error::DeprecationWarning", "-c",
             "import repro_torch.core; import repro_torch.core.hardware"],
            capture_output=True, text=True, timeout=120,
            env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
        assert out.returncode == 0, out.stderr

    def test_unknown_attribute_raises(self):
        from repro_torch.core import hardware

        with pytest.raises(AttributeError):
            _ = hardware.not_a_symbol

    def test_same_exports_as_the_reference(self):
        from repro_torch.core import hardware

        assert hardware._EXPORTS == jhardware._EXPORTS
        assert dir(hardware) == sorted(jhardware._EXPORTS)


class TestExactDelegation:
    def test_objects_are_identical(self):
        from repro_torch.core import hardware

        with pytest.warns(DeprecationWarning):
            for name in hardware._EXPORTS:
                assert getattr(hardware, name) is getattr(shift_add, name), name

    def test_table6_fig5_values_unchanged(self):
        from repro_torch.core import hardware

        with pytest.warns(DeprecationWarning):
            assert hardware.AREA_UM2 == {"fp32": 3218.3, "fp16": 3837.9,
                                         "bf16": 3501.9, "int8": 2103.4,
                                         "shift_add": 1635.4}
            assert hardware.area_saving_vs_int8() == pytest.approx(0.223, abs=1e-3)
            # Fig. 5 energy fit: A8W2 -> -25.0%, A8W4 -> -13.8% vs INT8
            assert float(hardware.mac_energy(2) - 1.0) == pytest.approx(-0.250, abs=0.005)
            assert float(hardware.mac_energy(4) - 1.0) == pytest.approx(-0.138, abs=0.005)
            assert hardware.AREA_UM2 == jhardware.AREA_UM2
            for bits in (2, 4, 6, 8):
                assert float(hardware.mac_energy(bits)) == float(jhardware.mac_energy(bits))

    def test_policy_pricing_identical(self):
        from repro_torch.core import hardware

        policy = BitPolicy.from_bits(_layers(), {"a": 4, "b": 8})
        with pytest.warns(DeprecationWarning):
            legacy = hardware.evaluate_policy(policy)
            jlegacy = jhardware.evaluate_policy(JBitPolicy.from_json(policy.to_json()))
        seam = shift_add.ShiftAddCostModel().report(policy)
        assert legacy.energy == seam.energy
        assert legacy.latency == seam.latency_s
        assert legacy.bops == seam.bops
        assert (legacy.energy, legacy.latency, legacy.bops) == pytest.approx(
            (jlegacy.energy, jlegacy.latency, jlegacy.bops), rel=1e-12)
