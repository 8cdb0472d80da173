"""The port's own host layer against the JAX package's: the port keeps
copies of fhe_si_tpu's JAX-free modules (sampling, hostmath, context,
cli/gen_data, apps/matrix, indexmap, the pure-Python codec of refserial)
and imports nothing of fhe_si_tpu.  Here the copies give the same draws,
tables, bounds, bytes and results as the originals, and no module of the
port imports fhe_si_tpu, jax or the JAX package's native codec core."""
import ast
import os
from pathlib import Path

import numpy as np
import pytest

from fhe_si_tpu import refserial as jrefserial, sampling as jsampling
from fhe_si_tpu.apps import matrix as jmatrix
from fhe_si_tpu.cli import gen_data as jgen
from fhe_si_tpu.context import FheContext as RefContext
from fhe_si_tpu.hostmath import oracle as joracle
from fhe_si_tpu_torch import FheContext, refserial, sampling
from fhe_si_tpu_torch.apps import matrix, regression, statistics
from fhe_si_tpu_torch.cli import gen_data
from fhe_si_tpu_torch.hostmath import oracle

REPO = Path(__file__).resolve().parent.parent

# (m, p, generator, prime_bits, log_q): both lanes at m = 32 and 256, the
# apps' derived logQ at m = 32, and a d = 4 extension-slot ring (m = 13,
# p = 5), whose slot tables come from hostmath/gf.py
CONTEXTS = [
    pytest.param((32, 97, 3, None, 80), id="m32"),
    pytest.param((256, 257, 3, None, 80), id="m256"),
    pytest.param((32, 97, 3, 23, 80), id="m32-wide"),
    pytest.param((256, 257, 3, 23, 80), id="m256-wide"),
    pytest.param((32, 97, 3, None, "regression"), id="m32-regression-logq"),
    pytest.param((32, 97, 3, None, "statistics"), id="m32-statistics-logq"),
    pytest.param((13, 5, 2, None, 80), id="m13-p5-d4"),
]
TABLES = ("residue_tables", "fast_crt_tables", "ksw_fast_crt_tables",
          "lin_fast_crt_tables", "ksw_value_primes", "lin_value_primes",
          "ksw_rows", "lin_rows", "exact_bounds", "reduction_growth",
          "garner_tables", "q_over_p_limbs", "decode_matrix", "embed_matrix")


def _kw(m, p, g, prime_bits, log_q):
    xi = 1
    if isinstance(log_q, str):
        app = regression if log_q == "regression" else statistics
        log_q, xi = app.derive_log_q(16, 2, p)
    return dict(m=m, log_q=log_q, p=p, generator=g, xi=xi,
                prime_bits=prime_bits)


def _same(a, b, path):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)) and a and not np.isscalar(a[0]):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and np.array_equal(x, y), path


@pytest.mark.parametrize("cfg", CONTEXTS)
def test_context_equals_reference(cfg):
    """Every attribute and every table and bound the port reads."""
    kw = _kw(*cfg)
    ref, ctx = RefContext(**kw), FheContext(**kw)
    assert type(ctx).__mro__[1:] == (object,)       # subclasses nothing
    mine = {k: v for k, v in vars(ctx).items() if k != "_automorph_perms"}
    theirs = {k: v for k, v in vars(ref).items() if k != "_automorph_perms"}
    _same(mine, theirs, "ctx")
    for name in TABLES:
        if name.endswith("_matrix") and ref.slot_degree > 1:
            continue            # the d > 1 slots keep decode_tensors instead
        want = getattr(ref, name)
        if isinstance(want, dict) and "B_chunks" in want:
            want = {k: v for k, v in want.items() if k != "B_chunks"}
        _same(getattr(ctx, name), want, name)
    for k in (ctx.generator, ctx.m - 1):
        _same(ctx.automorph_perm(k), ref.automorph_perm(k), f"perm {k}")
    rng = np.random.default_rng(cfg[0])
    vals = rng.integers(0, ctx.p, size=ctx.usable_slots)
    emb = ctx.embed_in_slots(vals)
    _same(emb, ref.embed_in_slots(vals), "embed_in_slots")
    _same(ctx.decode_slots(emb), ref.decode_slots(emb), "decode_slots")


@pytest.mark.parametrize("seed", [0, 7, 2024])
def test_random_source_draws_equal(seed):
    a, b = sampling.RandomSource(seed), jsampling.RandomSource(seed)
    for _ in range(2):
        _same(a.binary_poly(33), b.binary_poly(33), "binary")
        _same(a.gaussian_poly(33, 3.2), b.gaussian_poly(33, 3.2), "gauss")
        _same(a.hwt_poly(64, 12), b.hwt_poly(64, 12), "hwt")
        assert a.uniform_signed_q(9, 213) == b.uniform_signed_q(9, 213)
        assert a.uniform_signed_q(9, 80) == b.uniform_signed_q(9, 80)
        _same(a.uniform_mod_p(33, 40961), b.uniform_mod_p(33, 40961), "mod p")


@pytest.mark.parametrize("m,p", [(32, 97), (256, 257)])
def test_scheme_samplers_equal(m, p):
    ctx = FheContext(m=m, log_q=80, p=p, generator=3)
    a, b = sampling.RandomSource(m), jsampling.RandomSource(m)
    args = (ctx.phim, ctx.stdev, ctx.log_q)
    kg, kgj = sampling.sample_keygen(a, *args), jsampling.sample_keygen(b, *args)
    _same(kg.s, kgj.s, "s")
    _same(kg.c0, kgj.c0, "c0")
    assert kg.c1 == kgj.c1
    for n_parts in (2, 3):
        e = sampling.sample_encrypt(a, ctx.phim, ctx.stdev, n_parts)
        ej = jsampling.sample_encrypt(b, ctx.phim, ctx.stdev, n_parts)
        _same(e.r, ej.r, "r")
        _same(e.errors, ej.errors, "errors")
    ks = sampling.sample_keyswitch(a, *args, 3, ctx.ndigits)
    ksj = jsampling.sample_keyswitch(b, *args, 3, ctx.ndigits)
    assert ks.A == ksj.A
    _same(ks.e, ksj.e, "e")


def test_oracle_equals_reference():
    """The copied oracle through keygen, encrypt, the ops, relinearize,
    rotate and decrypt, each on its own package's context and draws."""
    kw = dict(m=32, log_q=80, p=97, generator=3)
    outs = []
    for Ctx, smp, orc in ((FheContext, sampling, oracle),
                          (RefContext, jsampling, joracle)):
        ctx, src = Ctx(**kw), smp.RandomSource(11)
        sk, pk = orc.keygen(ctx, smp.sample_keygen(
            src, ctx.phim, ctx.stdev, ctx.log_q))
        msgs = [src.uniform_mod_p(ctx.phim, ctx.p) for _ in range(2)]
        cts = [orc.encrypt(pk, mm, smp.sample_encrypt(src, ctx.phim,
                                                      ctx.stdev))
               for mm in msgs]
        ksw = orc.keyswitch_init_s2(sk, smp.sample_keyswitch(
            src, ctx.phim, ctx.stdev, ctx.log_q, 3, ctx.ndigits))
        rot = orc.keyswitch_init_automorph(sk, ctx.generator, smp.sample_keyswitch(
            src, ctx.phim, ctx.stdev, ctx.log_q, 2, ctx.ndigits))
        prod = orc.apply_keyswitch(ksw, orc.mul(cts[0], cts[1]))
        rotated = orc.apply_keyswitch(rot, orc.automorph(cts[0], ctx.generator))
        lin = orc.mul_const(orc.add(orc.mul_scalar(cts[0], 5), cts[1]), msgs[1])
        outs.append(dict(
            pk=pk.pk, sk=sk.s_keys, ksw=ksw.matrix,
            cts=[c.parts for c in cts], prod=prod.parts, rot=rotated.parts,
            lin=lin.parts, dec=[orc.decrypt(sk, c) for c in (prod, rotated, lin)],
            pt=[orc.plaintext_mul(ctx, *msgs),
                orc.plaintext_rotate(ctx, msgs[0], 1),
                orc.plaintext_automorph(ctx, msgs[0], ctx.generator)]))
    _same(outs[0], outs[1], "oracle")


def test_gen_data_equals_reference(tmp_path):
    for n_files in (1, 3):
        mine, ref = tmp_path / f"a{n_files}", tmp_path / f"b{n_files}"
        coeffs, names = gen_data.generate(str(mine), 4, 40, n_files, seed=9)
        jcoeffs, jnames = jgen.generate(str(ref), 4, 40, n_files, seed=9)
        assert coeffs == jcoeffs and len(names) == len(jnames) == n_files
        for x, y in zip(names, jnames):
            assert Path(x).read_text() == Path(y).read_text()


def test_matrix_equals_reference():
    rows = [[3, 1, 4, 1], [5, 9, 2, 6], [5, 3, 5, 8], [9, 7, 9, 3]]
    got, want = [], []
    for mod, out in ((matrix, got), (jmatrix, want)):
        A = mod.Matrix(rows)
        inv, det = A.invert()
        out.append((A.determinant(), det, _rows(inv),
                    _rows(A.mult_by_transpose()), _rows(A @ A.transpose())))
    assert got == want


def _rows(M):
    return [[M.at(i, j) for j in range(M.num_cols())]
            for i in range(M.num_rows())]


def _body_dump(path: Path) -> str:
    """The module's AST without its docstring."""
    tree = ast.parse(path.read_text())
    if isinstance(tree.body[0], ast.Expr) and isinstance(
            tree.body[0].value, ast.Constant):
        tree.body = tree.body[1:]
    return ast.dump(tree)


def test_indexmap_copy_equals_original():
    """fhe_si_tpu_torch/indexmap.py is fhe_si_tpu/indexmap.py below its
    docstring."""
    assert _body_dump(REPO / "fhe_si_tpu_torch" / "indexmap.py") == \
        _body_dump(REPO / "fhe_si_tpu" / "indexmap.py")


def test_refserial_bytes_equal_reference():
    """Every writer of the port's pure-Python codec gives the JAX
    package's bytes (whichever path its codec takes), and each package's
    readers give back what the other wrote."""
    rng = np.random.default_rng(5)
    big = [int(v) for v in rng.integers(-2 ** 62, 2 ** 62, 40)] + [
        0, 2 ** 300, -(2 ** 70), 7]
    rows = {int(i): rng.integers(0, 2 ** 61, 12) for i in (0, 3, 5)}
    chain = [(int(q), int(r)) for q, r in rng.integers(1, 2 ** 62, (4, 2))]
    cases = [
        ("write_context", "read_context", lambda m: m.RefContext(
            22, 80, 2 ** 40 + 15, 7, 3, chain)),
        ("write_ciphertext", "read_ciphertext", lambda m: [big, big[:5], []]),
        ("write_key", "read_key", lambda m: [rows, {}]),
        ("write_keyswitch", "read_keyswitch", lambda m: [[rows] * 3] * 2),
        ("write_ciphertext_matrix", "read_ciphertext_matrix",
         lambda m: [[[big[:3], big[3:9]]] * 2] * 3)]
    for write, read, obj in cases:
        buf = getattr(refserial, write)(obj(refserial))
        assert buf == getattr(jrefserial, write)(obj(jrefserial)), write
        for a, b in ((refserial, jrefserial), (jrefserial, refserial)):
            got, want = getattr(a, read)(buf), getattr(b, read)(buf)
            if read == "read_context":
                got, want = vars(got), vars(want)
            _same(got, want, read)


def _port_files():
    pkg = REPO / "fhe_si_tpu_torch"
    return sorted(pkg.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_nothing_of_jax_package():
    """An AST walk over every module of the port and chip_smoke.py: no
    import of fhe_si_tpu or jax, at any depth of the file."""
    files = _port_files()
    assert len(files) > 20
    mods = {os.path.relpath(f, REPO / "fhe_si_tpu_torch") for f in files}
    assert {"doublecrt.py", "indexmap.py", "serialization.py",
            "refserial.py", "refcompat.py"} <= mods
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
                # the JAX package's g++ codec core, by any path
                names += [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("fhe_si_tpu", "jax", "jaxlib") \
                        or "native" in name.split("."):
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno} "
                               f"{name}")
    assert not bad, bad
