"""Momentum-equation fvOptions: meanVelocityForce + semiImplicitSource.

The reference applies fv::options in its momentum equation
(``applications/cudaParticlesPimpleFoam/UEqn.H:11,17,23``, ``pEqn.H:66``);
these tests pin the XLA equivalents (models/fvoptions.py) against
analytic channel solutions and the sharded step against the single-device
one.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cudaparticlesfoam_tpu.io import blockmesh
from cudaparticlesfoam_tpu.models import fv, fvoptions, pimple
from cudaparticlesfoam_tpu.models.pimple import PimpleConfig, pimple_step
from cudaparticlesfoam_tpu.models.simple import FlowState

CHANNEL_BMD = """
FoamFile { version 2.0; format ascii; class dictionary; object blockMeshDict; }
scale 1;
vertices (
 (0 0 0) (1 0 0) (1 0.1 0) (0 0.1 0)
 (0 0 0.01) (1 0 0.01) (1 0.1 0.01) (0 0.1 0.01)
);
blocks ( hex (0 1 2 3 4 5 6 7) (20 16 1) simpleGrading (1 1 1) );
edges ();
boundary (
 inlet { type patch; faces ((0 4 7 3)); }
 outlet { type patch; faces ((1 2 6 5)); }
 walls { type wall; faces ((0 1 5 4) (3 7 6 2)); }
 frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""

H = 0.1
NU = 0.01
UBAR = 1.0


@pytest.fixture(scope="module")
def channel_pm(tmp_path_factory):
    d = tmp_path_factory.mktemp("fvo_chan")
    (d / "blockMeshDict").write_text(CHANNEL_BMD)
    return blockmesh.generate(str(d / "blockMeshDict"))


def _force_driven_setup(pm, dtype=jnp.float64):
    """Channel with zeroGradient U and fixed equal p at both ends: the only
    thing that can drive flow is a momentum source."""
    m = fv.fv_mesh(pm, dtype=dtype)
    u_bcs = fv.make_bcs(m, {"walls": ("noSlip", 0.0)}, 3,
                        default="zeroGradient")
    p_bcs = fv.make_bcs(
        m, {"inlet": ("fixedValue", 0.0), "outlet": ("fixedValue", 0.0)}, 1
    )
    u0 = jnp.zeros((m.n_cells, 3), dtype)
    st = FlowState(u=u0, p=jnp.zeros(m.n_cells, dtype),
                   flux=fv.flux_of(m, u0, u_bcs))
    return m, st, u_bcs, p_bcs


def _inert_fvo(m, dtype):
    z = jnp.zeros((), dtype)
    return fvoptions.FvOptions(
        su=jnp.zeros((m.n_cells, 3), dtype), sp=jnp.zeros(m.n_cells, dtype),
        mvf_dir=jnp.zeros(3, dtype), mvf_mask=jnp.zeros(m.n_cells, dtype),
        mvf_mag=z, mvf_relax=z + 1.0, grad_p=z, dgrad=z, has_mvf=False,
    )


def _run(m, st, u_bcs, p_bcs, fvo, n_steps, dt=0.02):
    cfg = PimpleConfig(nu=NU, n_correctors=2, n_jacobi=10, p_tol=1e-10,
                       p_max_iter=500)
    for _ in range(n_steps):
        st, res = pimple_step(m, st, u_bcs, p_bcs, cfg, dt, fvo=fvo)
        fvo = dataclasses.replace(fvo, grad_p=res["fvo_grad_p"],
                                  dgrad=res["fvo_dgrad"])
    return st, fvo


def test_parse_fv_options(channel_pm, tmp_path):
    (tmp_path / "system").mkdir()
    (tmp_path / "constant").mkdir()
    (tmp_path / "system" / "fvOptions").write_text(
        "FoamFile { version 2.0; format ascii; object fvOptions; }\n"
        "momentumSource {\n type meanVelocityForce;\n"
        " meanVelocityForceCoeffs {\n  selectionMode all;\n  fields (U);\n"
        "  Ubar (2 0 0);\n }\n}\n"
        "damping {\n type vectorSemiImplicitSource;\n volumeMode specific;\n"
        " selectionMode all;\n"
        " injectionRateSuSp {\n  U ((0.5 0 0) -2.0);\n }\n}\n"
    )
    m = fv.fv_mesh(channel_pm, dtype=jnp.float64)
    fvo = fvoptions.from_case(str(tmp_path), m)
    assert fvo is not None and fvo.has_mvf
    assert float(fvo.mvf_mag) == 2.0
    np.testing.assert_allclose(np.asarray(fvo.mvf_dir), [1.0, 0.0, 0.0])
    np.testing.assert_allclose(np.asarray(fvo.su)[:, 0], 0.5)
    np.testing.assert_allclose(np.asarray(fvo.sp), -2.0)
    assert np.asarray(fvo.mvf_mask).min() == 1.0
    # no momentum entries -> None
    (tmp_path / "system" / "fvOptions").write_text(
        "FoamFile { version 2.0; format ascii; object fvOptions; }\n"
    )
    assert fvoptions.from_case(str(tmp_path), m) is None
    # unknown type is a loud error, not a silent drop
    (tmp_path / "system" / "fvOptions").write_text(
        "FoamFile { version 2.0; format ascii; object fvOptions; }\n"
        "rot { type solidificationMeltingSource; }\n"
    )
    with pytest.raises(ValueError, match="not supported"):
        fvoptions.from_case(str(tmp_path), m)


def test_mean_velocity_force_channel(channel_pm):
    """meanVelocityForce drives a closed-loop Poiseuille flow: the zone
    mean velocity settles on |Ubar| and the accumulated gradient on the
    analytic 12 nu Ubar / H^2 (OpenFOAM channel-case semantics)."""
    m, st, u_bcs, p_bcs = _force_driven_setup(channel_pm)
    fvo = dataclasses.replace(
        _inert_fvo(m, jnp.float64),
        mvf_dir=jnp.asarray([1.0, 0.0, 0.0]),
        mvf_mask=jnp.ones(m.n_cells),
        mvf_mag=jnp.asarray(UBAR, jnp.float64),
        has_mvf=True,
    )
    st, fvo = _run(m, st, u_bcs, p_bcs, fvo, 150)
    u = np.asarray(st.u)
    cc = np.asarray(m.cc)
    vol = np.asarray(m.vol)
    # controller target: volume-mean of dir . u == |Ubar| (tight)
    mean_u = (vol * u[:, 0]).sum() / vol.sum()
    assert abs(mean_u - UBAR) < 1e-6, mean_u
    # Poiseuille profile at the mid-plane
    sel = np.abs(cc[:, 0] - 0.5) < 0.05
    y = cc[sel, 1]
    ana = 6.0 * UBAR * (y / H) * (1.0 - y / H)
    assert np.abs(u[sel, 0] - ana).max() / (1.5 * UBAR) < 0.03
    # driving gradient: dp/dx = 12 nu Ubar / H^2
    g_ana = 12.0 * NU * UBAR / H**2
    assert abs(float(fvo.grad_p) - g_ana) / g_ana < 0.03


def test_semi_implicit_source_su_channel(channel_pm):
    """Open-loop uniform Su force reproduces the same Poiseuille flow the
    analytic gradient would."""
    m, st, u_bcs, p_bcs = _force_driven_setup(channel_pm)
    g = 12.0 * NU * UBAR / H**2
    fvo = dataclasses.replace(
        _inert_fvo(m, jnp.float64),
        su=jnp.tile(jnp.asarray([[g, 0.0, 0.0]]), (m.n_cells, 1)),
    )
    st, _ = _run(m, st, u_bcs, p_bcs, fvo, 150)
    u = np.asarray(st.u)
    cc = np.asarray(m.cc)
    sel = np.abs(cc[:, 0] - 0.5) < 0.05
    y = cc[sel, 1]
    ana = 6.0 * UBAR * (y / H) * (1.0 - y / H)
    assert np.abs(u[sel, 0] - ana).max() / (1.5 * UBAR) < 0.03


def test_semi_implicit_source_sp_damping(channel_pm):
    """Su + implicit Sp damping: steady nu u'' + Su + Sp u = 0 has the
    exact solution (Su/c)(1 - cosh(k(y-H/2))/cosh(kH/2)), k=sqrt(c/nu),
    c=-Sp — pins the implicit diagonal contribution's sign and magnitude."""
    m, st, u_bcs, p_bcs = _force_driven_setup(channel_pm)
    su, c = 10.0, 50.0
    fvo = dataclasses.replace(
        _inert_fvo(m, jnp.float64),
        su=jnp.tile(jnp.asarray([[su, 0.0, 0.0]]), (m.n_cells, 1)),
        sp=jnp.full(m.n_cells, -c, jnp.float64),
    )
    st, _ = _run(m, st, u_bcs, p_bcs, fvo, 200)
    u = np.asarray(st.u)
    cc = np.asarray(m.cc)
    sel = np.abs(cc[:, 0] - 0.5) < 0.05
    y = cc[sel, 1]
    k = np.sqrt(c / NU)
    ana = (su / c) * (1.0 - np.cosh(k * (y - H / 2)) / np.cosh(k * H / 2))
    assert np.abs(u[sel, 0] - ana).max() / ana.max() < 0.03


def test_fvoptions_sharded_matches_single():
    """The sharded PIMPLE step with meanVelocityForce + semiImplicitSource
    reproduces the single-device step exactly (psum-global zone averages;
    VERDICT r4 next-round item 9)."""
    n_dev = 8
    try:
        if len(jax.devices("cpu")) < n_dev:
            pytest.skip("needs 8 virtual devices")
    except RuntimeError:
        pytest.skip("no CPU backend")
    from cudaparticlesfoam_tpu.parallel import flowshard, sharding

    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "blockMeshDict"), "w") as fh:
            fh.write(CHANNEL_BMD)
        pm = blockmesh.generate(os.path.join(d, "blockMeshDict"))
    m, st, u_bcs, p_bcs = _force_driven_setup(pm)
    fvo = dataclasses.replace(
        _inert_fvo(m, jnp.float64),
        su=jnp.tile(jnp.asarray([[3.0, 0.0, 0.0]]), (m.n_cells, 1)),
        sp=jnp.full(m.n_cells, -1.0, jnp.float64),
        mvf_dir=jnp.asarray([1.0, 0.0, 0.0]),
        mvf_mask=jnp.ones(m.n_cells),
        mvf_mag=jnp.asarray(UBAR, jnp.float64),
        has_mvf=True,
    )
    cfg = PimpleConfig(nu=NU, n_correctors=2, n_jacobi=8, p_tol=1e-12,
                       p_max_iter=600)
    dt, n_steps = 0.02, 3
    st1, fvo1 = st, fvo
    for _ in range(n_steps):
        st1, res = pimple_step(m, st1, u_bcs, p_bcs, cfg, dt, fvo=fvo1)
        fvo1 = dataclasses.replace(fvo1, grad_p=res["fvo_grad_p"],
                                   dgrad=res["fvo_dgrad"])

    smesh, bglob = flowshard.decompose(pm, n_dev, dtype=jnp.float64)
    dmesh = sharding.make_device_mesh(n_dev, axis="f")
    u_bcs_s = flowshard.shard_bcs(u_bcs, bglob)
    p_bcs_s = flowshard.shard_bcs(p_bcs, bglob)
    u_s = flowshard.scatter_cells(smesh, np.zeros((m.n_cells, 3)))
    p_s = flowshard.scatter_cells(smesh, np.zeros(m.n_cells))
    flux_s = flowshard.make_flux_init(smesh, dmesh)(smesh, u_s, u_bcs_s)
    su_s = flowshard.scatter_cells(smesh, np.asarray(fvo.su))
    sp_s = flowshard.scatter_cells(smesh, np.asarray(fvo.sp))
    mask_s = flowshard.scatter_cells(smesh, np.asarray(fvo.mvf_mask))
    step = flowshard.make_sharded_pimple(
        smesh, cfg, dmesh, with_fvo=True, fvo_mvf=True
    )
    grad_p, dgrad = 0.0, 0.0
    for _ in range(n_steps):
        par = jnp.asarray(
            [1.0, 0.0, 0.0, UBAR, 1.0, grad_p, dgrad], jnp.float64
        )
        u_s, p_s, flux_s, diag = step(
            smesh, u_s, p_s, flux_s, u_bcs_s, p_bcs_s, dt,
            su_s, sp_s, mask_s, par,
        )
        grad_p = float(np.asarray(diag["fvo_grad_p"])[0])
        dgrad = float(np.asarray(diag["fvo_dgrad"])[0])
    u_g = flowshard.gather_cells(smesh, u_s)
    du = np.abs(u_g - np.asarray(st1.u)).max()
    assert du < 1e-8, du
    dg = abs(grad_p - float(fvo1.grad_p)) + abs(dgrad - float(fvo1.dgrad))
    assert dg < 1e-8, dg
    # and the force actually produced flow
    assert u_g[:, 0].max() > 0.5
