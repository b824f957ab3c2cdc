"""Shared decks and checks of tests/test_torch_objects.py and
tests/test_torch_tiled_objects.py: the object decks of tests/test_objects.py
and tests/test_collisions.py, the tolerances, and the test that decides
whether a particle whose absorption differs between pinc_tpu and
pinc_tpu_torch met a cell face within float32 round-off."""

import numpy as np

L = 16
RADIUS = 2.5

# tests/test_collisions.py's SPHERE_DECK (16^3, a sphere of radius 2.5,
# 8 per cell, vth 0.2 / 0.05), with the object grid, the responses and the
# step count filled in
SPHERE_DECK = """
[objects]
objects = {path}
collisionType = {ctypes}
{see}
[time]
nTimeSteps = {steps}
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = 1,1,1
trueSize = 16,16,16
stepSize = 1
boundaries = {bnd}
{bnd_values}
[population]
nSpecies = 2
nParticles = 8 pc
nAlloc = 8 pc
charge = -1,1
mass = 1,100
multiplicity = auto
thermalVelocity = {vth}
[methods]
mode = regular
poisson = {poisson}
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
layout = {layout}
{extra}
"""

# input/sphereObject.ini's [multigrid] section
MG_SECTION = """[multigrid]
cycle = mgVRegular
mgLevels = 4
mgCycles = 10
nPreSmooth = 5
nPostSmooth = 5
nCoarseSolve = 10
"""

# tests/test_tiled_objects.py's [tiles] section
TILES = "[tiles]\ntileSize = 4\nmargin = 1\nrebucketEvery = 3\n"
# tests/test_collisions.py's (_TILES)
TILES_M2 = "[tiles]\ntileSize = 4\nmargin = 2\nrebucketEvery = 4\n"

#: the secondary deck of tests/test_collisions.py: ions emit electrons
SEE = "seeYield = 1\nseeVth = 0.1\nseeSpecies = 0"


def sphere_domain():
    from pinc_tpu_torch.objects import make_sphere
    return make_sphere((L,) * 3, (8, 8, 8), RADIUS)


def deck(path, ctype="absorb", steps=8, layout="flat", vth="0.2,0.05",
         walls=False, extra=""):
    """The sphere deck; ctype: one response for both species, or
    "secondary" (ions emit electrons, tests/test_collisions.py's deck);
    walls: Dirichlet walls of zero value and the multigrid."""
    ctypes = "absorb,secondary" if ctype == "secondary" else f"{ctype},{ctype}"
    return SPHERE_DECK.format(
        path=path, ctypes=ctypes, see=SEE if ctype == "secondary" else "",
        steps=steps, layout=layout, vth=vth,
        bnd="DIRICHLET" if walls else "PERIODIC",
        bnd_values="bndValues = 0,0,0,0,0,0" if walls else "",
        poisson="mgSolve" if walls else "sSolve",
        extra=(MG_SECTION if walls else "") + extra)


# distance of a decision point from the nearest cell face, below which
# float32 round-off (and the pre-step states' ~1e-6 differences) can decide
# on which side of the face it falls (an f32 ulp at 16 is 1.9e-6)
FACE_ROUNDOFF = 1e-5


def _interior(iid, x):
    c = np.clip(np.floor(np.mod(x, L)).astype(np.int64), 0, L - 1)
    return iid[c[0], c[1], c[2]] > 0


def face_distance(pos0, vel, iid, normals=None, n_bisect: int = 10) -> float:
    """The least distance, in float64, of a point the step tests against
    the object's cells from the nearest cell face: the moved position, the
    segment start, every bisection sample (on float64's path), the
    crossing, the backscattered end point and (normals given) the
    reflected one.  pos0, vel: one particle's global position and velocity
    before its move."""
    vel = np.asarray(vel, np.float64)
    p1 = np.mod(np.asarray(pos0, np.float64) + vel, L)
    prev = p1 - vel
    pts = [p1, prev]
    lo, hi = 0.0, 1.0
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        x = prev + mid * vel
        pts.append(x)
        if _interior(iid, x):
            hi = mid
        else:
            lo = mid
    x_int = prev + lo * vel
    pts += [x_int, x_int - (1.0 - lo) * vel]
    if normals is not None:
        c = np.clip(np.floor(np.mod(x_int, L)).astype(np.int64), 0, L - 1)
        n = normals[c[0], c[1], c[2]].astype(np.float64)
        pts.append(x_int + (1.0 - lo) * (vel - 2.0 * np.dot(vel, n) * n))
    pts = np.mod(np.stack(pts), L)
    return float(np.min(np.abs(pts - np.rint(pts))))


def assert_flip_within_roundoff(pos0, vel, iid, normals=None) -> float:
    """A particle whose alive flag differs between the packages after a
    step must have met a cell face within float32 round-off: some point
    the step tested lies within FACE_ROUNDOFF of a face."""
    d = face_distance(pos0, vel, iid, normals)
    assert d < FACE_ROUNDOFF, (
        f"a particle's absorption differs between the packages, but every "
        f"point its step tested lies {d:.3g} or more from a cell face "
        f"(pos {pos0}, vel {vel})")
    return d


def total_charge(q, alive_counts, rho_obj) -> float:
    """sum_s q_s * alive_s + sum(rho_obj), float64."""
    return float(np.sum(np.asarray(q, np.float64)
                        * np.asarray(alive_counts, np.float64))
                 + np.sum(np.asarray(rho_obj, np.float64)))


def match_flips(pre_a, pre_b, post_a, post_b, iid, normals=None,
                tol: float = 1e-3) -> int:
    """The particles whose alive flag after a step differs between two runs
    of one deck (a: the port, b: pinc_tpu; the layouts may differ, so
    particles are matched by species, position and velocity before the
    step, within tol), each checked with assert_flip_within_roundoff.
    pre_*: (pos (S, N, D), vel (S, N, D), alive (S, N)) before the step;
    post_*: alive (S, N) after it, in the same slots.  Returns the number
    of flips."""
    from scipy.spatial import cKDTree
    flips = 0
    for s in range(pre_a[2].shape[0]):
        ia = np.flatnonzero(pre_a[2][s])
        ib = np.flatnonzero(pre_b[2][s])
        key = lambda pre, i: np.concatenate(  # noqa: E731
            [pre[0][s][i], pre[1][s][i]], axis=-1).astype(np.float64)
        dist, j = cKDTree(key(pre_b, ib)).query(key(pre_a, ia),
                                                distance_upper_bound=tol)
        hit = np.isfinite(dist)
        a_alive = post_a[s][ia[hit]]
        b_alive = post_b[s][ib[j[hit]]]
        for k in np.flatnonzero(a_alive != b_alive):
            i = ib[j[hit][k]]
            assert_flip_within_roundoff(pre_b[0][s][i], pre_b[1][s][i], iid,
                                        normals)
            flips += 1
    return flips
