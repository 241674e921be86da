"""The plain reference equals the program's plain path on the CPU, at
test_params() for both word sizes."""

import pytest
import torch

import heref
from hebench import inputs, program
from repro_torch.core import heaan, rotate
from repro_torch.core import params as hp
from repro_torch.core.rns import PipelineConfig

CPU = torch.device("cpu")
PLAIN = PipelineConfig(use_kernels=False)


@pytest.mark.parametrize("beta", [32, 64])
@pytest.mark.parametrize("logN", [5, 7])
def test_reference_equals_the_programs_he_mul_and_rotate(beta, logN):
    p = hp.test_params(logN=logN, beta_bits=beta)
    g = inputs.generator(2**31 + 77, CPU)
    evk_w = inputs.key(g, p.N, p.logQ, beta, CPU)
    rk_w = inputs.key(g, p.N, p.logQ, beta, CPU)
    evk = program.eval_key(p, *evk_w, False, CPU)
    rk = program.eval_key(p, *rk_w, False, CPU)
    ref = heref.HERef(p.N, p.logQ, beta, CPU, chunk=2)
    for logq in (p.logQ, p.logQ - p.logp, 50):
        a1, b1 = inputs.ciphertexts(g, 3, p.N, logq, beta, CPU)
        a2, b2 = inputs.ciphertexts(g, 3, p.N, logq, beta, CPU)
        ra, rb = ref.he_mul(a1, b1, a2, b2, evk_w, logq)
        k = pow(5, 1, 2 * p.N)
        sa, sb = ref.rotate(a1, b1, k, rk_w, logq)
        for i in range(3):
            c1 = program.ciphertext(p, a1[i], b1[i], logq)
            c2 = program.ciphertext(p, a2[i], b2[i], logq)
            mul = heaan.he_mul(c1, c2, evk, p, PLAIN)
            assert torch.equal(mul.ax, ra[i]) and torch.equal(mul.bx, rb[i])
            rot = rotate.he_rotate(c1, 1, rk, p, PLAIN)
            assert torch.equal(rot.ax, sa[i]) and torch.equal(rot.bx, sb[i])


def test_negacyclic_product_equals_python_ints():
    N, bits = 16, 40
    rng = torch.Generator().manual_seed(3)
    a = torch.randint(0, 1 << 20, (N, 2), generator=rng)
    b = torch.randint(0, 1 << 20, (N, 2), generator=rng)
    ai = [int(x) + (int(y) << 20) for x, y in a.tolist()]
    bi = [int(x) + (int(y) << 20) for x, y in b.tolist()]
    want = [0] * N
    for i in range(N):
        for j in range(N):
            s = 1 if i + j < N else -1
            want[(i + j) % N] += s * ai[i] * bi[j]
    ring = heref.Ring(N, CPU, 200)

    def digits(v):
        return torch.tensor([[(x >> (16 * d)) & 0xFFFF for d in range(3)]
                             for x in v])
    off = 4 + 2 * bits + 1
    n = ring.count(off + 1)
    prod = ring.mul_ev(ring.ntt(ring.residues(digits(ai), n)),
                       ring.ntt(ring.residues(digits(bi), n)))
    out = ring.reconstruct(prod, off, 8)
    got = [sum(int(out[i, d]) << (16 * d) for d in range(8))
           for i in range(N)]
    assert got == [w % (1 << 128) for w in want]
