"""``fleet.fleet_surface_energy(stacked, trace, weight, impl='cuda',
module_chunk=)`` on the benchmark's synthetic fleet (``params.kind``
``synthetic_fleet``), resident on the device; the call ends in a
synchronise when the mix keeps the map on the device."""
import torch

from harness.program import Program as Base


class Program(Base):

    def setup(self, root, cfg, inputs):
        from repro_torch.core.energy_model import PowerParams
        if inputs.fleet is None:
            raise ValueError("a fleet map needs a synthetic_fleet "
                             "configuration")
        self.stacked = PowerParams(**{
            name: torch.from_numpy(x).to(self.device)
            for name, x in inputs.fleet.items()})
        self.n_sets = int(self.stacked.i2n.shape[0])
        self.module_chunk = int(self.mix["module_chunk"])

    def enter(self, batch):
        from repro_torch.core import fleet
        return fleet.fleet_surface_energy(
            self.stacked, batch.trace, batch.weight, impl="cuda",
            module_chunk=self.module_chunk)
