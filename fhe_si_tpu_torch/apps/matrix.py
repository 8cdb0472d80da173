"""Generic dense matrix over ring-like elements (reference Matrix.h:17-83,
Matrix.cpp:6-325).  The port's copy of fhe_si_tpu/apps/matrix.py.

Works over Python ints, Plaintext, and Ciphertext: elements must support
`a + b`, `a * b`, and `a * (-1)`.  Mirrors the reference's semantics —
lazy transpose flag, MultByTranspose (A @ A^T), adjugate-based Invert with
an injectable `reduce` callback (the key-switch hook, Matrix.cpp:182-214),
and the recursive cofactor Determinant (exponential in dim; the
regression workloads use dim <= 4) — but in a functional style: methods
return new matrices, matching the rest of this library.
"""
from __future__ import annotations

from typing import Callable, Optional


class Matrix:
    def __init__(self, rows: Optional[list[list]] = None):
        self.rows = [list(r) for r in rows] if rows else []
        self.transposed = False

    # ------------------------------------------------------------- structure
    def copy(self) -> "Matrix":
        m = Matrix(self.rows)
        m.transposed = self.transposed
        return m

    def num_rows(self) -> int:
        if not self.rows:
            return 0
        return len(self.rows[0]) if self.transposed else len(self.rows)

    def num_cols(self) -> int:
        if not self.rows:
            return 0
        return len(self.rows) if self.transposed else len(self.rows[0])

    def at(self, i: int, j: int):
        return self.rows[j][i] if self.transposed else self.rows[i][j]

    def set(self, i: int, j: int, v):
        if self.transposed:
            self.rows[j][i] = v
        else:
            self.rows[i][j] = v

    def add_row(self, row: list):
        assert not self.transposed, "cannot add a row to a transposed matrix"
        self.rows.append(list(row))

    def concatenate(self, other: "Matrix") -> "Matrix":
        """Row-wise append of `other` (Matrix<T>::Concatenate,
        Matrix.cpp:294-298).  The reference silently no-ops on a
        transposed *destination*; this returns a new matrix instead of
        mutating, matching the library's functional style."""
        assert not self.transposed, \
            "cannot concatenate onto a transposed matrix"
        m = self.copy()
        m.rows.extend([other.at(i, j) for j in range(other.num_cols())]
                      for i in range(other.num_rows()))
        return m

    def transpose(self) -> "Matrix":
        m = self.copy()
        m.transposed = not m.transposed
        return m

    def map_all(self, fn: Callable) -> "Matrix":
        """MapAll (Matrix.cpp:306-312): applies fn to the underlying storage."""
        m = Matrix([[fn(v) for v in row] for row in self.rows])
        m.transposed = self.transposed
        return m

    # ------------------------------------------------------------ arithmetic
    def __add__(self, other: "Matrix") -> "Matrix":
        out = Matrix()
        for i in range(self.num_rows()):
            out.add_row([self.at(i, j) + other.at(i, j)
                         for j in range(self.num_cols())])
        return out

    def __sub__(self, other: "Matrix") -> "Matrix":
        out = Matrix()
        for i in range(self.num_rows()):
            out.add_row([self.at(i, j) + other.at(i, j) * (-1)
                         for j in range(self.num_cols())])
        return out

    def __matmul__(self, other: "Matrix") -> "Matrix":
        out = Matrix()
        for i in range(self.num_rows()):
            row = []
            for j in range(other.num_cols()):
                acc = self.at(i, 0) * other.at(0, j)
                for k in range(1, self.num_cols()):
                    acc = acc + self.at(i, k) * other.at(k, j)
                row.append(acc)
            out.add_row(row)
        return out

    def mul_vector(self, vec: list) -> "Matrix":
        """A * v as a column matrix (Matrix.cpp:81-97)."""
        out = Matrix()
        for i in range(self.num_rows()):
            acc = self.at(i, 0) * vec[0]
            for j in range(1, self.num_cols()):
                acc = acc + self.at(i, j) * vec[j]
            out.add_row([acc])
        return out

    def scale(self, elem) -> "Matrix":
        return Matrix([[self.at(i, j) * elem for j in range(self.num_cols())]
                       for i in range(self.num_rows())])

    def mult_by_transpose(self) -> "Matrix":
        """A @ A^T, computing only the upper triangle and mirroring
        (Matrix.cpp:150-174)."""
        n, c = self.num_rows(), self.num_cols()
        out = [[None] * n for _ in range(n)]
        for i in range(n):
            for j in range(i, n):
                acc = self.at(i, 0) * self.at(j, 0)
                for k in range(1, c):
                    acc = acc + self.at(i, k) * self.at(j, k)
                out[i][j] = acc
                if i != j:
                    out[j][i] = acc
        return Matrix(out)

    # ----------------------------------------------------------- determinant
    def _determinant(self, used_rows, used_cols, dim, reduce):
        """Cofactor recursion (Matrix.cpp:224-263): row = first unused,
        alternate signs over unused columns, optional reduce after each
        accumulation level."""
        n = self.num_rows()
        row = 0
        while used_rows[row]:
            row += 1
        det = None
        negative = False
        for col in range(n):
            if used_cols[col]:
                continue
            if dim == 1:
                return self.at(row, col)
            tmp = self.at(row, col)
            if negative:
                tmp = tmp * (-1)
            negative = not negative
            used_rows[row] = used_cols[col] = True
            sub = self._determinant(used_rows, used_cols, dim - 1, reduce)
            used_rows[row] = used_cols[col] = False
            tmp = tmp * sub
            det = tmp if det is None else det + tmp
        if reduce is not None:
            det = reduce(det)
        return det

    def determinant(self, reduce: Optional[Callable] = None):
        n = self.num_rows()
        return self._determinant([False] * n, [False] * n, n, reduce)

    def invert_batched(self, mul_many: Callable, combine_signed: Callable,
                       reduce_many: Callable, negate_many: Callable):
        """Adjugate inverse computing each cofactor level as ONE batched
        device call instead of the element-at-a-time recursion of
        invert() (Matrix.cpp:182-263 semantics).

        Plaintext-equivalent to invert(reduce): every level-k minor is
        the same signed sum of entry*level-(k-1)-minor products and is
        reduced (key-switched) exactly once per level, like the recursive
        version; only the batching of independent products differs.

        Callbacks (see scheme.mul_batch/combine_signed_batch/relin_batch/
        scalar_mul_batch):
          mul_many(pairs) -> products (tensored)
          combine_signed(products, signs, group) -> one sum per group
          reduce_many(cts) -> relinearized cts
          negate_many(cts, signs) -> signed cts (non-tensored)
        Returns (adjugate Matrix, determinant) like invert().
        """
        import itertools
        n = self.num_rows()
        rows_wo = {i: [r for r in range(n) if r != i] for i in range(n)}
        # D[(i, S)] = det of the submatrix of rows_wo[i] (taken top-down,
        # level k uses row rows_wo[i][n-1-k]) and columns S
        D = {}
        for i in range(n):
            r = rows_wo[i][-1]
            for c in range(n):
                D[(i, (c,))] = self.at(r, c)
        for k in range(2, n):
            pairs, signs, keys = [], [], []
            for i in range(n):
                r = rows_wo[i][n - 1 - k]
                for S in itertools.combinations(range(n), k):
                    keys.append((i, S))
                    for t, c in enumerate(S):
                        sub = tuple(x for x in S if x != c)
                        pairs.append((self.at(r, c), D[(i, sub)]))
                        signs.append(-1 if t % 2 else 1)
            sums = reduce_many(combine_signed(mul_many(pairs), signs, k))
            for key, v in zip(keys, sums):
                D[key] = v
        # cofactors -> adjugate with the (-1)^(i+j) checkerboard
        flat, fsigns = [], []
        for i in range(n):
            for j in range(n):
                S = tuple(c for c in range(n) if c != j)
                flat.append(D[(i, S)])
                fsigns.append(-1 if (i + j) % 2 else 1)
        flat = negate_many(flat, fsigns)
        adj = [[None] * n for _ in range(n)]
        for i in range(n):
            for j in range(n):
                adj[j][i] = flat[i * n + j]
        adj_m = Matrix(adj)
        det_pairs = [(self.at(0, i), adj_m.at(i, 0)) for i in range(n)]
        det = reduce_many(combine_signed(mul_many(det_pairs), [1] * n, n))[0]
        return adj_m, det

    def invert(self, reduce: Optional[Callable] = None):
        """Adjugate inverse (Matrix.cpp:182-214): returns (adjugate matrix,
        determinant); the true inverse is adj/det, kept unscaled exactly as
        in the reference (the caller divides by the decrypted det)."""
        n = self.num_rows()
        adj = [[None] * n for _ in range(n)]
        used_rows, used_cols = [False] * n, [False] * n
        for i in range(n):
            for j in range(n):
                used_rows[i] = used_cols[j] = True
                cof = self._determinant(used_rows, used_cols, n - 1, reduce)
                used_rows[i] = used_cols[j] = False
                if (i + j) % 2 == 1:
                    cof = cof * (-1)
                adj[j][i] = cof
        adj_m = Matrix(adj)
        det = self.at(0, 0) * adj_m.at(0, 0)
        for i in range(1, n):
            det = det + self.at(0, i) * adj_m.at(i, 0)
        if reduce is not None:
            det = reduce(det)
        return adj_m, det
