# The paper's primary contribution: hypersolvers for continuous-depth models.
from repro_torch.core.tableaus import (  # noqa: F401
    Tableau, EULER, MIDPOINT, HEUN, RALSTON, RK4, RK38, RK3_KUTTA, DOPRI5,
    alpha_family, get as get_tableau,
)
from repro_torch.core.integrate import (  # noqa: F401
    Integrator, SegmentCarry, SolveStats, make_segment_carry, rk_stages,
    tree_axpy, tree_lincomb, with_initial,
)
from repro_torch.core.solvers import FixedGrid  # noqa: F401
from repro_torch.core.controllers import (  # noqa: F401
    EmbeddedErrorController, FixedController, HypersolverResidualController,
    TierRouter, embedded_step, mesh_for_tolerance, per_sample_norm,
)
from repro_torch.core.flowhead import flow_combine, make_flow_apply  # noqa: F401
from repro_torch.core.residual import (  # noqa: F401
    flow_fitting_loss, ledger_fitting_loss,
)
from repro_torch.core.train import (  # noqa: F401
    FlowTrainConfig, make_fit_step, train_flowhead,
)
