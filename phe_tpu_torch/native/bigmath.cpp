// Host-side fixed-capacity bignum engine: Montgomery modular exponentiation.
//
// This fills the role gmpy2/GMP plays for the reference library
// (phe/util.py:21-50 dispatches powmod to gmpy2 when importable): a native
// backend for the latency-sensitive *scalar* host path — key generation's
// Miller-Rabin witnesses and the scalar EncryptedNumber API's raw
// encrypt/decrypt modexps. The batched hot path runs on the GPU
// (phe_tpu_torch/csrc); this engine only accelerates one-off host calls.
//
// Representation: little-endian uint64 limb arrays, capacity fixed at
// compile time (MAX_LIMBS = 8192-bit moduli covers n^2 for 4096-bit keys).
// Odd moduli only (Paillier moduli n, n^2, p^2, q^2, p, q are all odd);
// the Python wrapper falls back to CPython pow for anything else.
//
// Algorithm: CIOS Montgomery multiplication over 64-bit limbs with
// unsigned __int128 partial products, 4-bit fixed-window exponentiation.
//
// Build: g++ -O3 -shared -fPIC -o bigmath.so bigmath.cpp  (no deps).

#include <cstdint>
#include <cstring>

using u64 = uint64_t;
using u128 = unsigned __int128;

static const int MAX_LIMBS = 129;  // 8192-bit modulus + headroom

namespace {

struct Ctx {
    u64 m[MAX_LIMBS];
    u64 r2[MAX_LIMBS];  // R^2 mod m
    u64 m0inv;          // -m[0]^-1 mod 2^64
    int L;
};

// -m^-1 mod 2^64 by Newton iteration (m odd).
u64 neg_inv64(u64 m) {
    u64 x = m;            // 3-bit correct
    for (int i = 0; i < 6; i++) x *= 2 - m * x;
    return ~x + 1;        // = -(m^-1) mod 2^64
}

int cmp_n(const u64* a, const u64* b, int L) {
    for (int i = L - 1; i >= 0; i--) {
        if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
    }
    return 0;
}

// a -= b (mod nothing), returns borrow.
u64 sub_n(u64* a, const u64* b, int L) {
    u64 borrow = 0;
    for (int i = 0; i < L; i++) {
        u64 bi = b[i] + borrow;
        u64 nb = (bi < borrow) | (a[i] < bi);
        a[i] -= bi;
        borrow = nb;
    }
    return borrow;
}

// a = 2a mod m (a < m on entry).
void dbl_mod(u64* a, const u64* m, int L) {
    u64 carry = 0;
    for (int i = 0; i < L; i++) {
        u64 nc = a[i] >> 63;
        a[i] = (a[i] << 1) | carry;
        carry = nc;
    }
    if (carry || cmp_n(a, m, L) >= 0) sub_n(a, m, L);
}

// CIOS Montgomery multiply: out = a * b * R^-1 mod m, all < m.
void mont_mul(u64* out, const u64* a, const u64* b, const Ctx& c) {
    const int L = c.L;
    u64 t[MAX_LIMBS + 2];
    std::memset(t, 0, sizeof(u64) * (L + 2));
    for (int i = 0; i < L; i++) {
        // t += a[i] * b
        u64 carry = 0;
        for (int j = 0; j < L; j++) {
            u128 s = (u128)a[i] * b[j] + t[j] + carry;
            t[j] = (u64)s;
            carry = (u64)(s >> 64);
        }
        u128 s = (u128)t[L] + carry;
        t[L] = (u64)s;
        t[L + 1] += (u64)(s >> 64);
        // q = t[0] * m0inv; t += q * m; t >>= 64
        u64 q = t[0] * c.m0inv;
        carry = 0;
        u128 s0 = (u128)q * c.m[0] + t[0];
        carry = (u64)(s0 >> 64);
        for (int j = 1; j < L; j++) {
            u128 sj = (u128)q * c.m[j] + t[j] + carry;
            t[j - 1] = (u64)sj;
            carry = (u64)(sj >> 64);
        }
        u128 sl = (u128)t[L] + carry;
        t[L - 1] = (u64)sl;
        t[L] = t[L + 1] + (u64)(sl >> 64);
        t[L + 1] = 0;
    }
    if (t[L] || cmp_n(t, c.m, L) >= 0) sub_n(t, c.m, L);
    std::memcpy(out, t, sizeof(u64) * L);
}

void build_ctx(Ctx& c, const u64* mod, int L) {
    c.L = L;
    std::memcpy(c.m, mod, sizeof(u64) * L);
    c.m0inv = neg_inv64(mod[0]);
    // R mod m: start from 2^(64L - 1) mod m (top bit), double once.
    u64 r[MAX_LIMBS];
    std::memset(r, 0, sizeof(u64) * L);
    // 2^k mod m for k = 64L via repeated doubling of 1 (simple, one-time).
    r[0] = 1;
    for (int k = 0; k < 64 * L; k++) dbl_mod(r, c.m, L);
    // R^2 mod m: double R mod m another 64L times.
    std::memcpy(c.r2, r, sizeof(u64) * L);
    for (int k = 0; k < 64 * L; k++) dbl_mod(c.r2, c.m, L);
}

}  // namespace

extern "C" {

// out = base^exp mod m. All little-endian u64 arrays; m odd, base < m,
// L = limb count of m (out has L limbs), ne = limb count of exp.
// Returns 0 on success, nonzero on unsupported input.
int phe_powmod(const u64* base, const u64* exp, int ne, const u64* mod,
               int L, u64* out) {
    if (L <= 0 || L > MAX_LIMBS - 1 || !(mod[0] & 1)) return 1;

    Ctx c;
    build_ctx(c, mod, L);

    // Montgomery form of base and of 1.
    u64 bm[MAX_LIMBS], one[MAX_LIMBS];
    mont_mul(bm, base, c.r2, c);
    std::memset(one, 0, sizeof(u64) * L);
    one[0] = 1;
    mont_mul(one, one, c.r2, c);  // = R mod m

    // 4-bit window table: table[k] = base^k in Montgomery form.
    u64 table[16][MAX_LIMBS];
    std::memcpy(table[0], one, sizeof(u64) * L);
    std::memcpy(table[1], bm, sizeof(u64) * L);
    for (int k = 2; k < 16; k++) mont_mul(table[k], table[k - 1], bm, c);

    // Find top nonzero nibble.
    int top = ne * 16 - 1;
    while (top >= 0 && ((exp[top / 16] >> (4 * (top % 16))) & 0xF) == 0)
        top--;

    u64 acc[MAX_LIMBS];
    std::memcpy(acc, one, sizeof(u64) * L);
    for (int w = top; w >= 0; w--) {
        if (w != top) {
            mont_mul(acc, acc, acc, c);
            mont_mul(acc, acc, acc, c);
            mont_mul(acc, acc, acc, c);
            mont_mul(acc, acc, acc, c);
        }
        unsigned d = (exp[w / 16] >> (4 * (w % 16))) & 0xF;
        if (w == top) {
            std::memcpy(acc, table[d], sizeof(u64) * L);
        } else if (d) {
            mont_mul(acc, acc, table[d], c);
        }
    }

    // Leave Montgomery domain: multiply by 1.
    u64 unit[MAX_LIMBS];
    std::memset(unit, 0, sizeof(u64) * L);
    unit[0] = 1;
    mont_mul(out, acc, unit, c);
    return 0;
}

// Batch Miller-Rabin witness checks: returns 1 if n passes all k witnesses
// (probable prime), 0 if any witness proves n composite. n odd > 3;
// witnesses: k contiguous L-limb numbers in (1, n-1).
int phe_miller_rabin(const u64* n, int L, const u64* witnesses, int k) {
    if (L <= 0 || L > MAX_LIMBS - 1 || !(n[0] & 1)) return -1;

    Ctx c;
    build_ctx(c, n, L);

    // n - 1 = d * 2^r
    u64 d[MAX_LIMBS];
    std::memcpy(d, n, sizeof(u64) * L);
    d[0] -= 1;  // n odd, no borrow
    int r = 0;
    while (!(d[0] & 1)) {
        for (int i = 0; i < L - 1; i++)
            d[i] = (d[i] >> 1) | (d[i + 1] << 63);
        d[L - 1] >>= 1;
        r++;
    }
    int nd = L;
    while (nd > 1 && d[nd - 1] == 0) nd--;

    u64 n1[MAX_LIMBS];  // n - 1
    std::memcpy(n1, n, sizeof(u64) * L);
    n1[0] -= 1;

    u64 x[MAX_LIMBS];
    for (int wi = 0; wi < k; wi++) {
        const u64* a = witnesses + (size_t)wi * L;
        if (phe_powmod(a, d, nd, n, L, x)) return -1;
        u64 is_one = 1, is_n1 = (u64)(cmp_n(x, n1, L) == 0);
        for (int i = 0; i < L; i++)
            if (x[i] != (i == 0 ? 1u : 0u)) { is_one = 0; break; }
        if (is_one || is_n1) continue;
        // Square r-1 times looking for n-1.
        Ctx cs;
        build_ctx(cs, n, L);
        u64 xm[MAX_LIMBS];
        mont_mul(xm, x, cs.r2, cs);
        bool witness_ok = false;
        for (int s = 0; s < r - 1; s++) {
            mont_mul(xm, xm, xm, cs);
            u64 unit[MAX_LIMBS];
            std::memset(unit, 0, sizeof(u64) * L);
            unit[0] = 1;
            mont_mul(x, xm, unit, cs);
            if (cmp_n(x, n1, L) == 0) { witness_ok = true; break; }
        }
        if (!witness_ok) return 0;
    }
    return 1;
}

}  // extern "C"
