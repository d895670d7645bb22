"""The one cost model and host link rate that the port's parity tests give
both packages' servers: the H100's.  The port defaults to them (its
``core.cost_model.H100`` and ``H100_HOST_LINK_BW``, fitted and measured on
the card); the JAX package keeps its TPU v5e defaults.  Its side is built
here through its own ``Hardware`` and ``analytic_cost_model`` at the same
rates, written out, so that both packages price recomputation and swaps
alike and their schedules stay equal."""
import repro.core.cost_model as jcm
import repro_torch.core.cost_model as tcm

# the port's H100 and H100_HOST_LINK_BW, written out
# (tests/test_torch_cost_model.py holds the port's constants to them)
H100_RATES = dict(name="h100-sxm", flops=989e12, hbm_bw=3.35e12,
                  ici_bw=450e9, mfu=0.5, kernel_launch=52.03e-3)
PCIE_BW = 42.39e9


def cost_model(M, cfg):
    """``cfg``'s analytic cost model at the H100's rates, built by the
    package that ``M`` (any module of either package) belongs to."""
    if M.__name__.split(".")[0] == "repro_torch":
        return tcm.analytic_cost_model(cfg, tcm.H100)
    return jcm.analytic_cost_model(cfg, jcm.Hardware(**H100_RATES))
