"""The paper's evaluation graphs (Table 1) as dry-run configs.

The sizes are written here; nothing is fetched.  ``dmax_block_est`` is the
planner's estimate of the max adjacency-fragment length per 16x16 block:
after degree ordering, U-row lengths are bounded by O(sqrt(m)) (arboricity
bound); per block they shrink by ~sqrt(p) (the paper's own observation,
§5.2).  We budget 4*sqrt(m)/q."""
import math

from .base import TCGraphConfig, register


def _mk(name, n, m, tri):
    q = 16
    dmax = max(64, int(4 * math.sqrt(m) / q))
    return TCGraphConfig(
        name=name,
        n_vertices=n,
        n_edges=m,
        n_triangles=tri,
        dmax_block_est=dmax,
    )


@register("tc-twitter")
def twitter():
    return _mk("tc-twitter", 41_652_230, 1_202_513_046, 34_824_916_864)


@register("tc-friendster")
def friendster():
    return _mk("tc-friendster", 119_432_957, 1_799_999_986, 191_716)


@register("tc-g500-s26")
def s26():
    return _mk("tc-g500-s26", 67_108_864, 1_073_741_824, 49_158_464_716)


@register("tc-g500-s27")
def s27():
    return _mk("tc-g500-s27", 134_217_728, 2_147_483_648, 106_858_898_940)


@register("tc-g500-s28")
def s28():
    return _mk("tc-g500-s28", 268_435_456, 4_294_967_296, 231_425_307_324)


@register("tc-g500-s29")
def s29():
    return _mk("tc-g500-s29", 536_870_912, 8_589_934_592, 499_542_556_876)
