"""torch port, MJCF compiled without mujoco (`dynamics/mjcf.py` and
`dynamics/model.py:compile_model`), against the JAX package's
`compile_model(mujoco.MjModel.from_xml_path(...))`:

- (a) the seven stand-in scenes under tests/assets, field by field;
- (b) small MJCF files written here, one feature each;
- (c) every rejection of the JAX compiler raised by the port too, and the
  port's own where mujoco compiles what its reader cannot reproduce;
- (d) `save_model` / `load_model` across the two packages;
- (e) go2_stand and h1_push_crate built from their XML plan as those built
  from the shipped `.npz` files (CPU, float64);
- scene resolution by name, `TPU_DIALMPC_ASSETS`, `.xml` or `.npz` path.

Tolerances: integers, bools, names and tables exactly; floats to
rtol = atol = 1e-12 (the same formulas in another operation order, and M⁻¹
from numpy where mujoco factors M itself); the planner outputs of (e) to
1e-9, as the port's float64 parity tests hold them.
"""

import dataclasses
from pathlib import Path

import mujoco
import numpy as np
import pytest
import torch

from torch_port_helpers import ASSETS, PORT_NPZ
from tpu_dialmpc.dynamics import model as jmodel
from tpu_dialmpc_torch.dynamics import assets as tassets
from tpu_dialmpc_torch.dynamics import mjcf
from tpu_dialmpc_torch.dynamics import model as tmodel

RTOL = ATOL = 1e-12
STANDIN_XML = sorted(ASSETS.glob("**/mjx_scene_*.xml"))


def _close_fields(jax_model, port_model):
    """Every PhysicsModel field and CollisionPairs table of the two models
    held to each other; returns the float fields that are bit-equal."""
    bit_equal = []

    def hold(name, a, b):
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape, a.dtype,
                                                               b.shape, b.dtype)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=name)
                if np.array_equal(a, b):
                    bit_equal.append(name)
            else:
                np.testing.assert_array_equal(b, a, err_msg=name)
        elif isinstance(a, float):
            assert type(b) is float and b == pytest.approx(a, rel=RTOL, abs=ATOL), name
            if a == b:
                bit_equal.append(name)
        else:
            assert type(a) is type(b) and a == b, (name, a, b)

    for f in dataclasses.fields(jmodel.PhysicsModel):
        a, b = getattr(jax_model, f.name), getattr(port_model, f.name)
        if f.name == "pairs":
            assert sorted(a) == sorted(b)
            for kind in a:
                for pf in dataclasses.fields(jmodel.CollisionPairs):
                    hold(f"pairs{kind}.{pf.name}", getattr(a[kind], pf.name),
                         getattr(b[kind], pf.name))
        elif f.name == "key_qpos":
            assert list(a) == list(b)
            for k in a:
                hold(f"key_qpos[{k}]", a[k], b[k])
        else:
            hold(f.name, a, b)
    return bit_equal


def _joint_names(mj):
    return tuple(mujoco.mj_id2name(mj, mujoco.mjtObj.mjOBJ_JOINT, j) or ""
                 for j in range(mj.njnt))


def _hold_to_mujoco(path, mj_assets=None):
    mj = mujoco.MjModel.from_xml_path(str(path), mj_assets or {})
    port = tmodel.compile_model(mjcf.load(path))
    bit_equal = _close_fields(jmodel.compile_model(mj), port)
    assert port.jnt_names == _joint_names(mj)
    return port, bit_equal


# ---- (a) the stand-in scenes ----


@pytest.mark.parametrize("path", STANDIN_XML, ids=[p.stem for p in STANDIN_XML])
def test_standin_scene_equals_jax_compile(path):
    assert len(STANDIN_XML) == 9  # the seven of the scene table, the H1-2 and fused pair-kinds
    port, bit_equal = _hold_to_mujoco(path)
    floats = [f.name for f in dataclasses.fields(port)
              if isinstance(getattr(port, f.name), (float, np.ndarray))
              and np.asarray(getattr(port, f.name)).dtype.kind == "f"]
    print(f"{path.stem}: bit-equal float fields {sorted(set(bit_equal) & set(floats))}; "
          f"within 1e-12: {sorted(set(floats) - set(bit_equal))}")


def test_mujoco_constants_at_qpos0():
    """mj_setConst's fields, held to mujoco on their own: body_invweight0 on
    every body (the crate on its slide is mujoco's simple body, 1/mass),
    dof_invweight0, meaninertia, and the weld and root ids."""
    for name in ("unitree_h1/mjx_scene_h1_push_crate.xml", "pairs/mjx_scene_pair_kinds.xml"):
        mj = mujoco.MjModel.from_xml_path(str(ASSETS / name))
        rec = mjcf.load(ASSETS / name)
        for f in ("body_invweight0", "dof_invweight0", "qpos0"):
            np.testing.assert_allclose(getattr(rec, f), getattr(mj, f), rtol=RTOL, atol=ATOL,
                                       err_msg=f)
        assert rec.stat.meaninertia == pytest.approx(mj.stat.meaninertia, rel=RTOL)
        np.testing.assert_array_equal(rec.body_weldid, mj.body_weldid)
        np.testing.assert_array_equal(rec.body_rootid, mj.body_rootid)


# ---- (b) one MJCF feature per case ----

ROBOT = """
    <body name="torso" pos="0 0 1" {torso}>
      <freejoint/>
      <geom name="torso" type="box" size="0.2 0.1 0.05"/>
      <site name="imu" pos="0 0 0.05"/>
      <body name="leg" pos="0.1 0 -0.05">
        <joint name="hip" {hip}/>
        <geom name="leg" type="capsule" size="0.03 0.1" pos="0 0 -0.1"/>
        <site name="foot" pos="0 0 -0.2"/>
      </body>
    </body>"""


def scene(body=ROBOT, head="", actuators='<motor joint="hip"/>', tail="", torso="",
          hip='axis="0 1 0" range="-1 1"'):
    return f"""<mujoco>
  {head}
  <worldbody>
    <geom name="floor" type="plane" size="0 0 0.05"/>
    {body.format(torso=torso, hip=hip)}
  </worldbody>
  <actuator>{actuators}</actuator>
  {tail}
</mujoco>"""


CASES = {
    "degree_euler_eulerseq": scene(
        head='<compiler angle="degree" eulerseq="zXy"/>',
        torso='euler="10 -20 30"', hip='axis="0 1 0" range="-45 60" ref="15"',
        tail='<keyframe><key name="home" qpos="0 0 1 1 0 0 0 0.2"/></keyframe>'),
    "degree_default_xyz": scene(
        head='<compiler angle="degree"/>', torso='euler="90 45 -30"',
        hip='axis="1 0 0" range="-90 90"'),
    "axisangle_xyaxes_zaxis": scene(
        head='<compiler angle="radian"/>', torso='axisangle="1 2 3 0.7"', body=ROBOT + """
    <body name="a" pos="1 0 0.5" xyaxes="0 1 0 -1 0 0"><freejoint/>
      <geom type="sphere" size="0.05" xyaxes="1 0 0 0 -1 0.2"/></body>
    <body name="b" pos="1 1 0.5" xyaxes="-1 0.1 0 0 -1 0"><freejoint/>
      <geom type="box" size="0.05 0.04 0.03" zaxis="-1 0 0.1"/>
      <site name="s" xyaxes="0 0 1 0 1 0"/>
      <geom type="box" size="0.01 0.02 0.03" pos="0 0 0.1"
        xyaxes="0.907634 0.402843 0.117977 0.336088 -0.865800 0.370724"/>
      <geom type="box" size="0.01 0.02 0.03" pos="0 0 0.2"
        xyaxes="-0.865800 0.402843 -0.296831 0.336088 0.907634 0.251488"/>
      <geom type="box" size="0.01 0.02 0.03" pos="0 0 0.3"
        xyaxes="-0.921219 0.370724 0.117977 -0.296831 -0.865800 0.402843"/></body>
    <body name="c" pos="1 2 0.5" xyaxes="0 0 -1 0 1 0"><freejoint/>
      <geom type="capsule" size="0.05 0.1" zaxis="0 0 -1"/></body>"""),
    "fromto_capsule_box": scene(body=ROBOT + """
    <body name="rod" pos="0.5 0 0.3"><freejoint/>
      <geom type="capsule" fromto="0 0 0 0.3 0.1 -0.05" size="0.02"/>
      <geom type="box" fromto="0 0 0 0 0.2 0.2" size="0.03 0.5"/>
      <geom type="cylinder" fromto="0.1 0 0 0.1 0 0.2" size="0.02" contype="0"
        conaffinity="0"/>
      <site name="tip" type="capsule" fromto="0 0 0 0 0 -0.1" size="0.01"/></body>"""),
    "fullinertia": scene(body=ROBOT + """
    <body name="lump" pos="0 1 0.3"><freejoint/>
      <inertial pos="0.01 0.02 0.03" mass="2" fullinertia="0.2 0.25 0.3 0.01 0.02 0.03"/>
      <geom type="sphere" size="0.05"/></body>
    <body name="lump2" pos="0 2 0.3"><freejoint/>
      <inertial pos="0 0 0" mass="1" fullinertia="0.1 0.1 0.1 0 0 0.01"/>
      <geom type="sphere" size="0.05"/></body>"""),
    "inertia_from_geoms_density": scene(body=ROBOT + """
    <body name="multi" pos="0 -1 0.3"><freejoint/>
      <geom type="sphere" size="0.05" pos="0.1 0 0" density="500"/>
      <geom type="capsule" size="0.02 0.1" pos="-0.05 0 0" euler="0.3 0.2 0.1"/>
      <geom type="box" size="0.03 0.04 0.05" pos="0 0.1 0" density="2000"/>
      <geom type="ellipsoid" size="0.03 0.04 0.05" pos="0 0 0.1" contype="0"
        conaffinity="0"/></body>
    <body name="one_capsule" pos="1 -1 0.3"><freejoint/>
      <geom type="capsule" size="0.03 0.2" quat="0.9 0.1 0.2 0.3"/></body>"""),
    "inertia_from_geoms_mass": scene(body=ROBOT + """
    <body name="crate" pos="1 0 0.5"><joint type="slide" axis="1 0 0" frictionloss="5"/>
      <geom type="box" size="0.6 0.4 0.55" mass="30"/></body>
    <body name="pair" pos="1 -1 0.3"><freejoint/>
      <geom type="sphere" size="0.05" pos="0.1 0 0" mass="0.4"/>
      <geom type="box" size="0.02 0.02 0.02" pos="-0.1 0.05 0" mass="0.1"/></body>"""),
    "nested_defaults_childclass": """<mujoco>
  <compiler angle="radian"/>
  <default>
    <geom friction="0.6 0.02 0.01" solimp="0.5 0.9 0.002"/>
    <joint damping="1" armature="0.02"/>
    <default class="robot">
      <joint damping="3" frictionloss="0.1" axis="0 1 0"/>
      <geom condim="1" friction="0.8"/>
      <motor ctrlrange="-5 5" gear="2"/>
      <default class="knee">
        <joint range="-2 -0.1" armature="0.05"/>
        <geom type="capsule" size="0.02 0.1" pos="0 0 -0.1"/>
        <motor ctrlrange="-9 9"/>
      </default>
      <default class="foot"><geom type="sphere" size="0.025" priority="1"/></default>
    </default>
  </default>
  <worldbody>
    <geom type="plane" size="0 0 0.05"/>
    <body name="base" pos="0 0 0.5" childclass="robot">
      <freejoint/>
      <geom type="box" size="0.1 0.1 0.05"/>
      <body name="thigh" pos="0 0 -0.05">
        <joint name="hip" range="-1 1"/>
        <geom class="knee"/>
        <body name="shin" pos="0 0 -0.2">
          <joint name="knee" class="knee"/>
          <geom class="knee" size="0.015"/>
          <geom class="foot" pos="0 0 -0.2"/>
        </body>
      </body>
    </body>
    <body name="ball" pos="1 0 0.5"><freejoint/><geom size="0.05" friction="0.9"/></body>
  </worldbody>
  <actuator>
    <motor joint="hip" class="robot"/>
    <motor joint="knee" class="knee" ctrlrange="-7 7"/>
  </actuator>
</mujoco>""",
    "include": """<mujoco>
  <include file="robot_part.xml"/>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 0.05"/>
    <body name="box" pos="1 0 0.1"><freejoint/><geom type="box" size="0.1 0.1 0.1"/></body>
  </worldbody>
  <keyframe><key name="home" qpos="0 0 1 1 0 0 0 0.3 1 0 0.1 1 0 0 0"/></keyframe>
</mujoco>""",
    "option_flags": scene(head="""<option timestep="0.004" gravity="0 0.5 -9" iterations="7"
      ls_iterations="3" tolerance="1e-6" ls_tolerance="0.05" impratio="2">
      <flag eulerdamp="disable" filterparent="disable"/></option>""", body=ROBOT + """
    <body name="child_contact" pos="1 0 0.5"><freejoint/><geom size="0.05"/>
      <body pos="0 0 0.1"><joint axis="1 0 0"/><geom size="0.05"/></body></body>"""),
    "solmix_priority_margin_gap": scene(body="""
    <body name="a" pos="0 0 0.5"><freejoint/>
      <geom size="0.05" solmix="3" solref="0.03 0.8" solimp="0.8 0.9 0.01 0.4 3"
        margin="0.01" gap="0.002" condim="4" friction="0.7 0.01 0.002"/>
      <geom type="box" size="0.05 0.05 0.05" pos="0.2 0 0" priority="2" condim="6"
        solref="-1000 -50" margin="0.004" friction="0.3 0.05 0.003"/>
      <geom type="capsule" size="0.02 0.1" pos="-0.2 0 0" solmix="0" solref="0.01 2"/>
    </body>
    <body name="b" pos="1 0 0.5"><freejoint/>
      <geom size="0.05" solmix="0.0001" margin="0.02" gap="0.01" solref="0.05 1.2"/></body>
    <body name="c" pos="2 0 0.5"><freejoint/>
      <geom size="0.05" contype="2" conaffinity="2"/>
      <geom type="box" size="0.05 0.05 0.05" contype="2" conaffinity="1" pos="0.1 0 0"/>
    </body>""", actuators=""),
    "motor_gear": scene(actuators="""<motor joint="hip" gear="25" ctrlrange="-1 1"
      forcerange="-20 20" forcelimited="false"/><motor joint="hip" gear="-3 0 0 0 0 0"/>"""),
    "position_kp_kv_forcerange": """<mujoco>
  <default>
    <default class="servo"><position kp="30" kv="0.65" ctrlrange="-1 1" forcerange="-9 9"/>
    </default>
    <default class="weak"><motor gear="2"/></default>
  </default>
  <worldbody>
    <geom type="plane" size="0 0 0.05"/>
    <body pos="0 0 1"><freejoint/><geom type="box" size="0.1 0.1 0.1"/>
      <body name="l1"><joint name="j1" axis="0 1 0" range="-1 1"/>
        <geom type="capsule" size="0.02 0.1" pos="0 0 -0.1"/></body>
      <body name="l2"><joint name="j2" type="slide" axis="0 0 1" range="-0.1 0.1"/>
        <geom size="0.03"/></body></body>
  </worldbody>
  <actuator>
    <position joint="j1" class="servo"/>
    <position joint="j1" class="servo" kp="12" forcerange="-4 4"/>
    <position joint="j2" class="weak" kp="5" kv="0.1" ctrllimited="false" ctrlrange="-1 1"/>
    <motor joint="j1" class="servo"/>
    <velocity joint="j2" kv="3"/>
    <velocity joint="j2" kv="2" class="servo"/>
    <general joint="j1" gainprm="7" biastype="affine" biasprm="0.5 -7 -0.2"
      ctrlrange="-2 2" forcerange="-3 3" gear="1.5"/>
  </actuator>
</mujoco>""",
    "hinge_ref": scene(head='<compiler angle="radian"/>', hip='axis="0 1 0" ref="0.3" '
                       'range="-0.5 1.2" margin="0.01" solreflimit="0.01 0.9" '
                       'solimplimit="0.8 0.9 0.002" solreffriction="0.03 1" '
                       'solimpfriction="0.7 0.8 0.003" frictionloss="0.4"'),
    "visual_mesh_absent": """<mujoco>
  <asset><mesh name="shell" file="shell_absent.obj"/></asset>
  <default><default class="visual"><geom type="mesh" contype="0" conaffinity="0" group="2"/>
  </default></default>
  <worldbody>
    <geom type="plane" size="0 0 0.05"/>
    <body name="base" pos="0 0 0.5"><freejoint/>
      <inertial pos="0 0 0" mass="2" diaginertia="0.01 0.01 0.01"/>
      <geom class="visual" mesh="shell"/>
      <geom type="sphere" size="0.05"/></body>
  </worldbody>
</mujoco>""",
    "contact_exclude_ignored": scene(body="""
    <body name="a" pos="0 0 0.5"><freejoint/><geom size="0.05"/></body>
    <body name="b" pos="0.5 0 0.5"><freejoint/><geom size="0.05"/></body>""", actuators="",
        tail='<contact><exclude body1="a" body2="b"/><pair geom1="floor" geom2="floor"/>'
             '</contact>'),
    "mocap_key_without_qpos": scene(body=ROBOT + """
    <body name="box_body" mocap="true" pos="1.3 0 0.15">
      <geom type="box" size="0.3 0.4 0.15"/></body>""",
        head='<size nkey="4"/>',
        tail='<keyframe><key name="rest"/><key qpos="0 0 2 0 0 0 1 0.5"/></keyframe>'),
}
# files the cases include, and the mesh only mujoco reads (the port never does)
INCLUDED = {"include": {"robot_part.xml": f"""<mujoco model="part">
  <compiler angle="radian"/>
  <default><joint damping="0.5"/></default>
  <worldbody>{ROBOT.format(torso='quat="0.9 0 0.1 0"', hip='axis="0 1 0"')}</worldbody>
  <actuator><motor joint="hip" ctrlrange="-3 3"/></actuator>
</mujoco>"""}}
MESHES = {"visual_mesh_absent": {"shell_absent.obj": b"v 0 0 0\nv 0.1 0 0\nv 0 0.1 0\n"
                                                     b"v 0 0 0.1\nf 1 2 3\nf 1 2 4\n"
                                                     b"f 1 3 4\nf 2 3 4\n"}}


def _write(tmp_path, name, xml, extra=None):
    for fname, text in (extra or {}).items():
        (tmp_path / fname).write_text(text)
    path = tmp_path / f"{name}.xml"
    path.write_text(xml)
    return path


@pytest.mark.parametrize("case", list(CASES))
def test_mjcf_case_equals_jax_compile(case, tmp_path):
    path = _write(tmp_path, case, CASES[case], INCLUDED.get(case))
    port, _ = _hold_to_mujoco(path, MESHES.get(case))
    if case == "contact_exclude_ignored":
        # the JAX compiler ignores <exclude>: the excluded bodies still pair
        assert (2, 2) in port.pairs and len(port.pairs[(2, 2)].geom1) == 1
    if case == "visual_mesh_absent":
        assert not (tmp_path / "shell_absent.obj").exists()
        assert list(port.geom_orig_id) == [0, 2]  # the mesh geom keeps its id


# ---- (c) rejections ----

REJECTED = {  # JAX compile_model's error, raised by the port as well
    "tendon": (scene(tail='<tendon><fixed><joint joint="hip" coef="1"/></fixed></tendon>'),
               "equality constraints / tendons"),
    "equality": (scene(body=ROBOT + """
    <body name="b2" pos="1 0 1"><freejoint/><geom size="0.05"/>
      <body><joint name="h2" axis="0 1 0"/><geom size="0.02"/></body></body>""",
                       tail='<equality><joint joint1="hip" joint2="h2"/></equality>'),
                 "equality constraints / tendons"),
    "ball_joint": (scene(hip='type="ball"', actuators=""), "only free/slide/hinge"),
    "two_joints_one_body": (scene(hip='axis="0 1 0"/><joint name="hip2" axis="1 0 0"'),
                            "bodies with >1 joint"),
    "collidable_cylinder": (scene(body=ROBOT + """
    <body pos="1 0 1"><freejoint/><geom type="cylinder" size="0.05 0.1"/></body>"""),
                            "collidable geom type 5"),
    "site_transmission": (scene(actuators='<motor site="foot" gear="0 0 1 0 0 0"/>'),
                          "only joint-transmission actuators"),
    "actuator_on_free_joint": (scene(body=ROBOT.replace("<freejoint/>",
                                                        '<joint name="root" type="free"/>'),
                                     actuators='<motor joint="root"/>'),
                               "actuators on free joints"),
    "activation_dynamics": (scene(actuators='<position joint="hip" kp="3" timeconst="0.1"/>'),
                            "actuator activation dynamics"),
}


@pytest.mark.parametrize("case", list(REJECTED))
def test_port_rejects_what_jax_rejects(case, tmp_path):
    xml, message = REJECTED[case]
    path = _write(tmp_path, case, xml)
    with pytest.raises(NotImplementedError, match=message):
        jmodel.compile_model(mujoco.MjModel.from_xml_path(str(path)))
    with pytest.raises(NotImplementedError, match=message):
        tmodel.compile_model(mjcf.load(path))


READER_REJECTS = {  # mujoco compiles these; the reader cannot reproduce them
    "frame": scene(body=ROBOT + '<frame pos="1 0 0"><body><freejoint/><geom size="0.1"/>'
                   '</body></frame>'),
    "mesh_inertia": scene(body=ROBOT + '<body pos="1 0 1"><freejoint/>'
                          '<geom type="mesh" mesh="m"/></body>',
                          head='<asset><mesh name="m" file="m.obj"/></asset>'),
    "boundmass": scene(head='<compiler boundmass="0.01"/>'),
    "settotalmass": scene(head='<compiler settotalmass="20"/>'),
    "dampratio": scene(actuators='<position joint="hip" kp="3" dampratio="1"/>'),
    "muscle": scene(actuators='<muscle joint="hip"/>'),
}


@pytest.mark.parametrize("case", list(READER_REJECTS))
def test_reader_raises_where_it_cannot_follow_mujoco(case, tmp_path):
    path = _write(tmp_path, case, READER_REJECTS[case])
    with pytest.raises(NotImplementedError):
        mjcf.load(path)


# ---- (d) save_model / load_model across the packages ----


def _stand_in(name="unitree_h1/mjx_scene_h1_push_crate.xml"):
    return mujoco.MjModel.from_xml_path(str(ASSETS / name))


def test_port_save_model_loads_in_jax(tmp_path):
    port = tmodel.compile_model(mjcf.load(ASSETS / "unitree_h1/mjx_scene_h1_push_crate.xml"))
    tmodel.save_model(port, str(tmp_path / "m.npz"))
    assert _close_fields(jmodel.load_model(str(tmp_path / "m.npz")), port)
    back = tmodel.load_model(str(tmp_path / "m.npz"))
    assert back.jnt_names == port.jnt_names and "crate_slide" in back.jnt_names
    _close_fields(back, port)


def test_jax_save_model_loads_in_port(tmp_path):
    jax_model = jmodel.compile_model(_stand_in("unitree_go2/mjx_scene_force_crate.xml"))
    jmodel.save_model(jax_model, str(tmp_path / "m.npz"))
    port = tmodel.load_model(str(tmp_path / "m.npz"))
    assert port.jnt_names == ()
    _close_fields(jax_model, port)


def test_save_model_writes_the_shipped_file_format(tmp_path):
    """The shipped go2_force.npz, saved again by the port, has the same
    entries, meta and arrays."""
    tmodel.save_model(tmodel.load_model(str(PORT_NPZ)), str(tmp_path / "m.npz"))
    with np.load(PORT_NPZ) as want, np.load(tmp_path / "m.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---- scene resolution ----


def test_load_scene_resolution(tmp_path, monkeypatch):
    monkeypatch.delenv("TPU_DIALMPC_ASSETS", raising=False)
    shipped = tmodel.load_scene("go2_force")  # the shipped .npz, as before
    _close_fields(tmodel.load_model(str(PORT_NPZ)), shipped)
    from_npz = tmodel.load_scene(str(PORT_NPZ))
    _close_fields(shipped, from_npz)
    xml = ASSETS / "unitree_go2/mjx_scene_force.xml"
    from_xml = tmodel.load_scene(str(xml))
    _close_fields(jmodel.compile_model(_stand_in("unitree_go2/mjx_scene_force.xml")), from_xml)
    # a name under TPU_DIALMPC_ASSETS is compiled from its XML
    monkeypatch.setenv("TPU_DIALMPC_ASSETS", str(ASSETS))
    by_name = tmodel.load_scene("go2_force")
    _close_fields(jmodel.compile_model(_stand_in("unitree_go2/mjx_scene_force.xml")), by_name)
    monkeypatch.setenv("TPU_DIALMPC_ASSETS", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="set TPU_DIALMPC_ASSETS"):
        tmodel.load_scene("go2_force")
    with pytest.raises(FileNotFoundError):
        tmodel.load_scene(str(tmp_path / "absent.npz"))
    assert tassets.scene_path("h1_walk") == tmp_path / tassets.SCENES["h1_walk"]


# ---- (e) envs built from XML plan as those built from the .npz files ----

SIZE = dict(Nsample=8, Hsample=4, Hnode=2)


@pytest.mark.parametrize("task", ["go2_stand", "h1_push_crate"])
def test_env_from_xml_plans_as_env_from_npz(task, monkeypatch):
    from tpu_dialmpc_torch.envs import dial_defaults, get_env
    from tpu_dialmpc_torch.envs.base import to_lean
    from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI

    monkeypatch.delenv("TPU_DIALMPC_ASSETS", raising=False)
    kw = dict(device="cpu", n_substeps=1, dtype="float64")
    from_npz = get_env(task, **kw)
    monkeypatch.setenv("TPU_DIALMPC_ASSETS", str(ASSETS))
    from_xml = get_env(task, **kw)
    assert from_xml.model is not from_npz.model
    cfg = DialConfig(**dict(dial_defaults(task), **SIZE))
    noise = torch.randn((cfg.Nsample, cfg.Hnode + 1, from_npz.action_size),
                        generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    out = []
    for env in (from_npz, from_xml):
        mb = MBDPI(cfg, env)
        Y = torch.zeros((cfg.Hnode + 1, env.action_size), dtype=torch.float64)
        scale = torch.as_tensor(mb.sigma_control, dtype=torch.float64)
        out.append(mb.reverse_once(to_lean(env.reset()), None, Y, scale, noise=noise))
    (Y0, info0), (Y1, info1) = out
    np.testing.assert_allclose(info1.rews.numpy(), info0.rews.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(Y1.numpy(), Y0.numpy(), rtol=0, atol=1e-9)
    assert torch.isfinite(Y1).all()


def test_h1_env_reads_joint_names_from_xml(monkeypatch):
    from tpu_dialmpc_torch.envs import get_env

    monkeypatch.setenv("TPU_DIALMPC_ASSETS", str(ASSETS))
    env = get_env("h1_walk", device="cpu", joint_range_source="centered")
    assert env.model.jnt_names[1] == "left_hip_yaw"
    assert Path(tassets.scene_path("h1_walk")).is_file()


def test_cli_config_takes_a_scene_path(tmp_path):
    """`--config` with `env: {scene: <an MJCF path>}` builds the env from
    that file, as the JAX CLI's `_build` does."""
    import argparse

    from tpu_dialmpc.cli.main import _build as jbuild
    from tpu_dialmpc_torch.cli import main as tcli

    xml = ASSETS / "unitree_h1/mjx_scene_h1_push_crate.xml"
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"task: h1_push_crate\nenv: {{scene: {xml}}}\n")
    ns = argparse.Namespace(task="go2_stand", config=str(cfg), nsample=None, hsample=None,
                            n_steps=None, substeps=None, device="cpu")
    jenv, _, jtask = jbuild(ns)
    tenv, _, ttask = tcli._build(ns)
    assert ttask == jtask == "h1_push_crate" and tenv.config.scene == str(xml)
    _close_fields(jenv.model, tenv.model)


@pytest.mark.parametrize("task", ["go2_crate", "go2_crate_climb", "go2_jump"])
def test_crate_task_from_xml_equals_jax_env(monkeypatch, task):
    """The crate tasks' envs built from XML (the crate moved in the compiled
    model) against the JAX envs (moved in the MjModel, then compiled)."""
    from tpu_dialmpc.envs import get_env as jget_env
    from tpu_dialmpc_torch.envs import get_env

    monkeypatch.setenv("TPU_DIALMPC_ASSETS", str(ASSETS))
    jenv, tenv = jget_env(task), get_env(task, device="cpu")
    _close_fields(jenv.model, tenv.model)
    assert tenv._crate == jenv._crate
