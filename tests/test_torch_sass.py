"""The SASS path counter behind the kernels' issue bounds
(``tools/sass_count.py``), on listings written in ``cuobjdump -sass``'s
format: label and hex branch targets, predicated exits, slow blocks branched
over, subroutine calls with and without a predicate, uniform-predicate
branches."""

import pytest

from ldpcsimulation_tpu_torch.tools import sass_count as sc

HEADER = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_14demoILb1EEEvPf
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
"""

# entry, guard, a 3-instruction slow block branched over, a store, a call,
# a store, EXIT; the subroutine (2 instructions) and the padding after it
BODY = """
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   ISETP.GE.AND P0, PT, R0, 0x10, PT ;
        /*0030*/               @P0 EXIT ;
        /*0040*/                   FSETP.GT.AND P1, PT, R0, 1, PT ;
        /*0050*/               @P1 BRA {skip} ;
        /*0060*/                   FMUL R2, R0, R0 ;
        /*0070*/                   FMUL R2, R2, R2 ;
        /*0080*/                   FMUL R2, R2, R2 ;
{label0}        /*0090*/                   STG.E [R4.64], R2 ;
        /*00a0*/               {callpred}CALL.REL.NOINC {sub} ;
        /*00b0*/                   STG.E [R4.64+0x4], R2 ;
        /*00c0*/                   EXIT ;
{label1}        /*00d0*/                   MOV R3, R2 ;
        /*00e0*/                   RET.REL.NODEC R20 `(_ZN12_GLOBAL__N_14demo) ;
{label2}        /*00f0*/                   BRA {self} ;
        /*0100*/                   NOP ;
"""


def _listing(labels: bool, callpred: str = "@P1 "):
    if labels:
        kw = dict(skip="`(.L_x_0)", sub="`(.L_x_1)", self="`(.L_x_2)",
                  label0=".L_x_0:\n", label1=".L_x_1:\n",
                  label2=".L_x_2:\n")
    else:
        kw = dict(skip="0x90", sub="0xd0", self="0xf0", label0="",
                  label1="", label2="")
    return HEADER + BODY.format(callpred=callpred, **kw)


@pytest.mark.parametrize("labels", [True, False])
def test_path_skips_slow_block_and_predicated_call(labels):
    k = sc.find(sc.parse(_listing(labels)), "demoILb1EE")
    assert k.static_count == 15
    # 0000 0010 0020 0030 0040 0050 | 0090 00a0 00b0 00c0
    assert k.path_length() == 10
    assert k.path_length(loads=True) == 10
    # through the first store only: its shortest way on to an EXIT
    assert k.path_length(stores=1) == 10


def test_unpredicated_call_counts_its_subroutine():
    k = sc.find(sc.parse(_listing(True, callpred="")), "demo")
    assert k.path_length() == 12  # + MOV, RET


def test_uniform_predicate_branch_is_conditional():
    text = HEADER + """
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   BRA.U !UP0, 0x40 ;
        /*0020*/                   STG.E [R4.64], R0 ;
        /*0030*/                   EXIT ;
        /*0040*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0050*/                   STG.E [R4.64], R0 ;
        /*0060*/                   EXIT ;
"""
    k = sc.find(sc.parse(text), "demo")
    # a store on both sides: through both means taking the branch, which
    # only a conditional branch allows after the first store — so the
    # fall-through path through the first store cannot reach the second
    with pytest.raises(ValueError, match="no path"):
        k.path_length()
    assert k._shortest(0, k._ops({"EXIT"})) == 3


def test_loads_of_other_store_copies_are_not_on_the_path():
    """A run-time branch picks one of two copies, each loading then
    storing: the path takes the first copy's load and store and skips the
    second copy, loads included."""
    text = HEADER + """
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDG.E R2, [R4.64] ;
        /*0020*/                   ISETP.NE.AND P0, PT, R0, 0x1, PT ;
        /*0030*/               @P0 BRA 0x70 ;
        /*0040*/                   LDG.E R3, [R6.64] ;
        /*0050*/                   STG.E [R8.64], R3 ;
        /*0060*/                   EXIT ;
        /*0070*/                   LDG.E R3, [R6.64+0x4] ;
        /*0080*/                   FADD R3, R3, R2 ;
        /*0090*/                   STG.E [R8.64], R3 ;
        /*00a0*/                   EXIT ;
"""
    k = sc.find(sc.parse(text), "demo")
    assert k.path_length(stores=1, loads=True) == 7  # 0000 to 0060
    assert k.path_length(stores=1) == 7
    with pytest.raises(ValueError, match="no path"):
        k.path_length(loads=True)  # both stores: not on one path


def test_issue_bound_and_lookup():
    # 132 SMs x 4 warp instructions per clock at 1000 MHz: 528e9 per second
    assert sc.issue_ms(32 * 528, 1_000_000, 1000.0) == pytest.approx(1.0)
    with pytest.raises(KeyError):
        sc.find(sc.parse(_listing(True)), "absent")


LOOP = HEADER + """
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   MOV R2, RZ ;
        /*0020*/                   LDG.E R3, [R4.64] ;
        /*0030*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0040*/                   ISETP.GE.AND P0, PT, R2, R0, PT ;
        /*0050*/              @!P0 BRA 0x20 ;
        /*0060*/                   ISETP.GT.AND P1, PT, R0, 0x20, PT ;
        /*0070*/               @P1 BRA 0xa0 ;
        /*0080*/                   STG.E [R4.64], R3 ;
        /*0090*/                   EXIT ;
        /*00a0*/                   LDG.E R3, [R4.64+0x4] ;
        /*00b0*/                   STG.E [R4.64], R3 ;
        /*00c0*/                   EXIT ;
"""


@pytest.mark.parametrize("trips,extra,want", [
    # S2R MOV, [LDG IADD3 ISETP BRA] per trip, ISETP BRA, STG EXIT
    (1, False, 2 + 4 + 2 + 2),
    (3, False, 2 + 3 * 4 + 2 + 2),
    # the other side of the second branch: LDG STG EXIT
    (2, True, 2 + 2 * 4 + 2 + 3),
])
def test_path_through_loop_trips(trips, extra, want):
    """A run-time loop's trips are named by repeating one of its loads;
    the path between two waypoints takes the branch that reaches the
    next one."""
    k = sc.find(sc.parse(LOOP), "demo")
    ld, st = 2, (11 if extra else 8)
    waypoints = [ld] * trips + ([10] if extra else []) + [st]
    assert k.path_through(waypoints) == want
    # no waypoint: one trip (the loop's body precedes its test)
    assert k.path_through([]) == k.path_length(stores=1) == 10


def test_path_through_refuses_unreachable_order():
    k = sc.find(sc.parse(LOOP), "demo")
    with pytest.raises(ValueError, match="no path"):
        k.path_through([8, 2])  # no way back into the loop from its exit


def _b1_listing() -> str:
    """B1's loop layout: two row-table loads; in each 32-slot half a loop
    of four message loads, then two, then one; a loop of one store per
    half; EXIT."""
    body = ["S2R R0, SR_TID.X ;", "LDG.E R6, [R4.64] ;",
            "LDG.E R7, [R4.64+0x80] ;"]
    loops = {}
    for h in range(2):
        loops[f"four{h}"] = len(body)
        body += [f"LDG.E.64 R{8 + j}, [R2.64] ;" for j in range(4)]
        body += ["ISETP.GE.AND P0, PT, R0, 0x4, PT ;",
                 f"@!P0 BRA {loops[f'four{h}'] * 16:#x} ;"]
        body += ["LDG.E.64 R8, [R2.64] ;", "LDG.E.64 R9, [R2.64] ;",
                 "LDG.E.64 R8, [R2.64] ;"]
    for h in range(2):
        loops[f"store{h}"] = len(body)
        body += ["STG.E.128 [R2.64], R8 ;",
                 "ISETP.GE.AND P1, PT, R0, 0x1, PT ;",
                 f"@!P1 BRA {loops[f'store{h}'] * 16:#x} ;"]
    body.append("EXIT ;")
    return HEADER + "".join(f"        /*{i * 16:04x}*/                   "
                            f"{x}\n" for i, x in enumerate(body))


@pytest.mark.parametrize("degree,way", [
    # loads at 1, 2; half 0: fours 3-6, two 9-10, one 11; half 1: fours
    # 12-15, two 18-19, one 20; stores 21 (half 0) and 24 (half 1)
    (1, [11, 21]),
    (6, [3, 4, 5, 6, 9, 10] + [21] * 6),
    (32, [3, 4, 5, 6] * 8 + [21] * 32),
    (39, [3, 4, 5, 6] * 8 + [12, 13, 14, 15, 18, 19, 20] + [21] * 32
     + [24] * 7),
])
def test_b1_sass_path_walks_the_slot_loops(degree, way):
    """``chip_smoke.b1_sass_path`` names a check's loads and stores in the
    order its slot loops execute them; another layout gives None (the
    count is a diagnostic, never a failure)."""
    import chip_smoke

    k = sc.find(sc.parse(_b1_listing()), "demo")
    assert chip_smoke.b1_sass_path(k, degree) == k.path_through(way)
    assert chip_smoke.b1_sass_path(sc.find(sc.parse(LOOP), "demo"),
                                   degree) is None
