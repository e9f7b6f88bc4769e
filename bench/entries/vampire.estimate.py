"""``Vampire.estimate(batch, vendors, mode=, impl='cuda')`` on a model
loaded by ``model_api.load_estimator`` from the configuration's fit
file (``params.kind`` ``fit_file``); the report is copied to the host
when the mix says so."""
from harness.program import Program as Base


class Program(Base):

    def setup(self, root, cfg, inputs):
        from repro_torch.core import model_api
        params = cfg["params"]
        if params["kind"] != "fit_file":
            raise ValueError("Vampire.estimate takes a fit file, not "
                             f"{params['kind']!r}")
        self.model = model_api.load_estimator(str(root / params["file"]),
                                              device=self.device)
        self.vendors = tuple(int(v) for v in params["vendors"])
        self.n_sets = len(self.vendors)

    def enter(self, batch):
        return self.model.estimate(batch, vendors=self.vendors,
                                   mode=self.mode, impl="cuda")
