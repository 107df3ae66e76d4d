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
