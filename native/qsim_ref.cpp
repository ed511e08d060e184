// Reference statevector simulator in C++ — the independent numerics oracle
// for the JAX engine, playing the role qiskit-aer's C++ simulator
// plays for the reference (SURVEY.md §2.11). Consumes the same circuit IR
// (gate kind / qubit / control codes from dqgp/ops/circuit.py) plus a
// precomputed (B, G) angle matrix; produces statevectors and single-qubit
// Pauli expectation features.
//
// Build: g++ -O3 -shared -fPIC -o libqsim_ref.so qsim_ref.cpp

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>

using cd = std::complex<double>;

namespace {
// Gate kind codes — MUST match dqgp/ops/circuit.py.
enum Kind { RX = 0, RY, RZ, H, CX, CZ, CRX, CRY, CRZ, RZZ };

constexpr double kSqrt1_2 = 0.70710678118654752440;

inline void apply_1q(cd* st, long long dim, int q, cd m00, cd m01, cd m10,
                     cd m11, int control) {
    const long long s = 1LL << q;
    for (long long i = 0; i < dim; ++i) {
        if (i & s) continue;                      // visit each pair once
        if (control >= 0 && !((i >> control) & 1)) {
            // pair (i, i+s): control bit identical for both iff control != q
            // (guaranteed by the IR); skip when control bit is 0.
            continue;
        }
        const cd a = st[i];
        const cd b = st[i + s];
        st[i] = m00 * a + m01 * b;
        st[i + s] = m10 * a + m11 * b;
    }
}
}  // namespace

extern "C" {

// kinds/qubits/controls: int32[G]; angles: float64[B*G] row-major;
// out: float64[B * 2^n * 2] interleaved (re, im). Returns 0 on success.
int simulate_states(int n, long long B, long long G, const int32_t* kinds,
                    const int32_t* qubits, const int32_t* controls,
                    const double* angles, double* out) {
    const long long dim = 1LL << n;
    cd* st = new cd[dim];
    for (long long b = 0; b < B; ++b) {
        std::memset(st, 0, sizeof(cd) * dim);
        st[0] = 1.0;
        for (long long g = 0; g < G; ++g) {
            const double a = angles[b * G + g];
            const int q = qubits[g];
            const int c = controls[g];
            const double ch = std::cos(0.5 * a);
            const double sh = std::sin(0.5 * a);
            switch (kinds[g]) {
                case RX:
                    apply_1q(st, dim, q, ch, cd(0, -sh), cd(0, -sh), ch, -1);
                    break;
                case CRX:
                    apply_1q(st, dim, q, ch, cd(0, -sh), cd(0, -sh), ch, c);
                    break;
                case RY:
                    apply_1q(st, dim, q, ch, -sh, sh, ch, -1);
                    break;
                case CRY:
                    apply_1q(st, dim, q, ch, -sh, sh, ch, c);
                    break;
                case RZ:
                    apply_1q(st, dim, q, cd(ch, -sh), 0, 0, cd(ch, sh), -1);
                    break;
                case CRZ:
                    apply_1q(st, dim, q, cd(ch, -sh), 0, 0, cd(ch, sh), c);
                    break;
                case H:
                    apply_1q(st, dim, q, kSqrt1_2, kSqrt1_2, kSqrt1_2,
                             -kSqrt1_2, -1);
                    break;
                case CX:
                    apply_1q(st, dim, q, 0, 1, 1, 0, c);
                    break;
                case CZ:
                    apply_1q(st, dim, q, 1, 0, 0, -1, c);
                    break;
                case RZZ: {
                    const long long sq = 1LL << q;
                    const long long sc = 1LL << c;
                    const cd em(ch, -sh), ep(ch, sh);
                    for (long long i = 0; i < dim; ++i) {
                        const bool agree = ((i & sq) != 0) == ((i & sc) != 0);
                        st[i] *= agree ? em : ep;
                    }
                    break;
                }
                default:
                    delete[] st;
                    return 1;
            }
        }
        double* row = out + b * dim * 2;
        for (long long i = 0; i < dim; ++i) {
            row[2 * i] = st[i].real();
            row[2 * i + 1] = st[i].imag();
        }
    }
    delete[] st;
    return 0;
}

// Single-qubit Pauli features from interleaved states:
// states float64[B * 2^n * 2] -> feats float64[B * 3n] as [X.. Y.. Z..].
void pauli_features(int n, long long B, const double* states, double* feats) {
    const long long dim = 1LL << n;
    for (long long b = 0; b < B; ++b) {
        const double* row = states + b * dim * 2;
        for (int q = 0; q < n; ++q) {
            const long long s = 1LL << q;
            double xr = 0, yi = 0, z = 0;
            for (long long i = 0; i < dim; ++i) {
                const double re = row[2 * i];
                const double im = row[2 * i + 1];
                const double p = re * re + im * im;
                z += (i & s) ? -p : p;
                if (!(i & s)) {
                    const double pre = row[2 * (i + s)];
                    const double pim = row[2 * (i + s) + 1];
                    xr += re * pre + im * pim;   // Re(conj(s0) s1)
                    yi += re * pim - im * pre;   // Im(conj(s0) s1)
                }
            }
            feats[b * 3 * n + q] = 2.0 * xr;
            feats[b * 3 * n + n + q] = 2.0 * yi;
            feats[b * 3 * n + 2 * n + q] = z;
        }
    }
}

}  // extern "C"
