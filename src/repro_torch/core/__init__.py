# The paper's primary contribution: hypersolvers for continuous-depth models.
from repro_torch.core.tableaus import (  # noqa: F401
    Tableau, EULER, MIDPOINT, HEUN, RALSTON, RK4, RK38, RK3_KUTTA, DOPRI5,
    alpha_family, get as get_tableau,
)
from repro_torch.core.integrate import (  # noqa: F401
    Integrator, SegmentCarry, SolveStats, as_integrator, depth_like,
    make_segment_carry, rk_stages, tree_axpy, tree_lincomb, with_initial,
)
from repro_torch.core.solvers import (  # noqa: F401
    FixedGrid, odeint_fixed, rk_psi, local_error, nfe_per_step,
)
from repro_torch.core.controllers import (  # noqa: F401
    EmbeddedErrorController, FixedController, HypersolverResidualController,
    TierRouter, embedded_step, error_ratio, mesh_for_tolerance,
    per_sample_norm, step_factor,
)
from repro_torch.core.flowhead import flow_combine, make_flow_apply  # noqa: F401
from repro_torch.core.adaptive import odeint_dopri5  # noqa: F401
from repro_torch.core.hypersolver import (  # noqa: F401
    HyperSolver, make as make_solver,
)
from repro_torch.core.residual import (  # noqa: F401
    solver_residual, residual_fitting_loss, trajectory_fitting_loss,
    combined_loss, flow_fitting_loss, ledger_fitting_loss,
)
from repro_torch.core.neural_ode import NeuralODE  # noqa: F401
from repro_torch.core.train import (  # noqa: F401
    FlowTrainConfig, HypersolverTrainConfig, train_flowhead,
    train_hypersolver, make_hypersolver, make_integrator, bind_g,
    make_fit_step,
)
