"""The port's pheutil CLI (python -m phe_tpu_torch.cli) against phe_tpu's.

Both CLIs run in-process through click's CliRunner on the same 256-bit JWK
files, the port with ``--device cpu`` (its vector commands then run the
plain PyTorch versions), mirroring tests/test_cli.py's cases for all
thirteen commands. Where r does not enter (extract, decrypt, decryptvec,
and the scalar commands with both keys' get_random_lt_n patched to one
value) the outputs are byte-equal; where it does (genpkey, and the vector
commands, which draw r on the device) each package's output decrypts in
both to the same values, which equal the exactly rounded results. phe_tpu
runs its RNS engine with the XLA ladder. Tolerance zero throughout.
"""

import json
import random
import subprocess
import sys
from fractions import Fraction

import pytest
from click.testing import CliRunner

from phe_tpu import keys as jkeys
from phe_tpu import serial as jserial
from phe_tpu.cli import cli as jcli

from phe_tpu_torch import keys as tkeys
from phe_tpu_torch import serial
from phe_tpu_torch.__about__ import __version__
from phe_tpu_torch.cli import cli as tcli

PORT = ["--device", "cpu"]
SCALARS = ["5", "3.1415", "-42.5", "1e-10", "0.0", "1e12"]
VALS = [1.5, -2.0, 300.0, 0.0625, -1e-3, 12345.678]
PLAIN = [10.0, 0.5, -1.0, 3.0, 1e6, -0.25]


@pytest.fixture(autouse=True)
def _force_rns(monkeypatch):
    monkeypatch.setenv("PHE_TPU_ENGINE", "rns")
    monkeypatch.setenv("PHE_TPU_RNS_KERNEL", "xla")


def _run(cli, args, port=False):
    result = CliRunner().invoke(cli, (PORT if port else []) + list(args))
    assert result.exit_code == 0, result.output
    return result.stdout


def _both(args, tmp_path, name):
    """Run args through both CLIs, each writing its own --output file;
    return (port file, phe_tpu file)."""
    outs = []
    for which, cli in (("port", tcli), ("phe_tpu", jcli)):
        out = tmp_path / ("%s_%s.json" % (name, which))
        _run(cli, [args[0], "--output", str(out)] + list(args[1:]),
             port=cli is tcli)
        outs.append(out)
    return outs


def _last(stdout):
    return stdout.strip().splitlines()[-1]


def _decrypt_both(priv_file, enc_file):
    """(port's decrypt, phe_tpu's decrypt) of one ciphertext file."""
    return tuple(float(_last(_run(cli, ["decrypt", str(priv_file),
                                        str(enc_file)], port=cli is tcli)))
                 for cli in (tcli, jcli))


def _decryptvec_both(priv_file, enc_file):
    outs = [_run(cli, ["decryptvec", str(priv_file), str(enc_file)],
                 port=cli is tcli) for cli in (tcli, jcli)]
    assert outs[0] == outs[1]
    return json.loads(_last(outs[0]))


@pytest.fixture(scope="module")
def keyfiles(tmp_path_factory):
    """phe_tpu's 256-bit private key and the public half both extract."""
    d = tmp_path_factory.mktemp("keys")
    priv_file, pub_file = d / "priv.json", d / "pub.json"
    _run(jcli, ["genpkey", "--keysize", "256", str(priv_file)])
    _run(jcli, ["extract", str(priv_file), str(pub_file)])
    return priv_file, pub_file


@pytest.fixture
def pinned_r(monkeypatch):
    """One blinding factor for both packages' host obfuscation."""
    r = 1 + random.Random(9).randrange(2**200)
    monkeypatch.setattr(jkeys.PaillierPublicKey, "get_random_lt_n",
                        lambda self: r)
    monkeypatch.setattr(tkeys.PaillierPublicKey, "get_random_lt_n",
                        lambda self: r)


@pytest.fixture
def vector(keyfiles, tmp_path):
    """VALS and PLAIN as JSON files, and VALS encrypted by phe_tpu."""
    _, pub_file = keyfiles
    vals, plain = tmp_path / "vals.json", tmp_path / "plain.json"
    vals.write_text(json.dumps(VALS))
    plain.write_text(json.dumps(PLAIN))
    enc = tmp_path / "enc.json"
    _run(jcli, ["encryptvec", str(pub_file), str(vals), "--output",
                str(enc)])
    return vals, plain, enc


def test_version_reads_the_port_about():
    out = _run(tcli, ["--version"])
    assert out.strip() == "pheutil, version %s" % __version__


def test_module_runs_as_a_script():
    out = subprocess.run(
        [sys.executable, "-m", "phe_tpu_torch.cli", "--help"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for command in ("genpkey", "extract", "encrypt", "decrypt", "add",
                    "addenc", "multiply", "encryptvec", "decryptvec",
                    "addvec", "addencvec", "multiplyvec", "sumvec"):
        assert command in out.stdout
    assert "--device" in out.stdout


def test_genpkey_keys_load_in_both_packages(tmp_path):
    for cli in (tcli, jcli):
        priv_file = tmp_path / ("priv%d.json" % (cli is tcli))
        _run(cli, ["genpkey", "--keysize", "256", "--id", "x",
                   str(priv_file)], port=cli is tcli)
        data = json.loads(priv_file.read_text())
        mine = serial.private_key_from_jwk(data)
        theirs = jserial.private_key_from_jwk(data)
        assert (mine.p, mine.q) == (theirs.p, theirs.q)
        assert mine.public_key.n.bit_length() == 256
        assert sorted(data) == ["key_ops", "kid", "kty", "p", "pub", "q"]


def test_extract_byte_equal(keyfiles, tmp_path):
    priv_file, _ = keyfiles
    mine, theirs = (tmp_path / "a.json", tmp_path / "b.json")
    _run(tcli, ["extract", str(priv_file), str(mine)], port=True)
    _run(jcli, ["extract", str(priv_file), str(theirs)])
    assert mine.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("value", SCALARS)
def test_encrypt_byte_equal_and_decrypt_equal(keyfiles, tmp_path, pinned_r,
                                              value):
    priv_file, pub_file = keyfiles
    mine, theirs = _both(["encrypt", str(pub_file), "--", value], tmp_path,
                         "enc")
    assert mine.read_bytes() == theirs.read_bytes()
    assert json.loads(mine.read_text())["e"] <= -32
    assert _decrypt_both(priv_file, mine) == (float(value), float(value))
    outs = [_run(cli, ["decrypt", str(priv_file), str(theirs)],
                 port=cli is tcli) for cli in (tcli, jcli)]
    assert outs[0] == outs[1]


def test_encrypt_with_fresh_r_decrypts_in_both(keyfiles, tmp_path):
    priv_file, pub_file = keyfiles
    mine, theirs = _both(["encrypt", str(pub_file), "--", "-9.75"], tmp_path,
                         "enc")
    assert mine.read_text() != theirs.read_text()
    assert _decrypt_both(priv_file, mine) == (-9.75, -9.75)
    assert _decrypt_both(priv_file, theirs) == (-9.75, -9.75)


@pytest.mark.parametrize("command,operand,want", [
    ("add", "2.25", 3.75), ("multiply", "-7", -10.5)])
def test_add_and_multiply_byte_equal(keyfiles, tmp_path, pinned_r, command,
                                     operand, want):
    priv_file, pub_file = keyfiles
    enc = tmp_path / "a.json"
    _run(jcli, ["encrypt", str(pub_file), "--output", str(enc), "1.5"])
    mine, theirs = _both([command, str(pub_file), str(enc), "--", operand],
                         tmp_path, command)
    assert mine.read_bytes() == theirs.read_bytes()
    assert _decrypt_both(priv_file, mine) == (want, want)


def test_addenc_byte_equal(keyfiles, tmp_path, pinned_r):
    priv_file, pub_file = keyfiles
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    _run(jcli, ["encrypt", str(pub_file), "--output", str(a), "10"])
    _run(tcli, ["encrypt", str(pub_file), "--output", str(b), "--", "-4.5"],
         port=True)
    mine, theirs = _both(["addenc", str(pub_file), str(a), str(b)], tmp_path,
                         "sum")
    assert mine.read_bytes() == theirs.read_bytes()
    assert _decrypt_both(priv_file, mine) == (5.5, 5.5)


def test_encryptvec_decryptvec(keyfiles, tmp_path, vector):
    priv_file, pub_file = keyfiles
    vals, _, _ = vector
    mine, theirs = _both(["encryptvec", str(pub_file), str(vals)], tmp_path,
                         "vec")
    for out in (mine, theirs):
        payload = json.loads(out.read_text())
        assert len(payload["values"]) == len(VALS)
        assert all(v["e"] <= -32 for v in payload["values"])
        assert _decryptvec_both(priv_file, out) == VALS
    # Every element is a valid single-ciphertext payload.
    single = tmp_path / "single.json"
    single.write_text(json.dumps(json.loads(mine.read_text())["values"][2]))
    assert _decrypt_both(priv_file, single) == (VALS[2], VALS[2])


def test_addvec(keyfiles, tmp_path, vector):
    priv_file, pub_file = keyfiles
    _, plain, enc = vector
    for out in _both(["addvec", str(pub_file), str(enc), str(plain)],
                     tmp_path, "added"):
        assert _decryptvec_both(priv_file, out) == [
            v + p for v, p in zip(VALS, PLAIN)]


def test_addencvec(keyfiles, tmp_path, vector):
    priv_file, pub_file = keyfiles
    vals, _, enc = vector
    other = tmp_path / "other.json"
    _run(tcli, ["encryptvec", str(pub_file), str(vals), "--output",
                str(other)], port=True)
    for out in _both(["addencvec", str(pub_file), str(enc), str(other)],
                     tmp_path, "doubled"):
        assert _decryptvec_both(priv_file, out) == [2 * v for v in VALS]


def test_multiplyvec(keyfiles, tmp_path, vector):
    priv_file, pub_file = keyfiles
    _, plain, enc = vector
    got = [_decryptvec_both(priv_file, out) for out in _both(
        ["multiplyvec", str(pub_file), str(enc), str(plain)], tmp_path,
        "scaled")]
    assert got[0] == got[1]
    assert got[0] == [v * p for v, p in zip(VALS, PLAIN)]


def test_sumvec(keyfiles, tmp_path, vector):
    priv_file, pub_file = keyfiles
    _, _, enc = vector
    for out in _both(["sumvec", str(pub_file), str(enc)], tmp_path, "sum"):
        assert set(json.loads(out.read_text())) == {"v", "e"}
        got = _decrypt_both(priv_file, out)
        assert got[0] == got[1] == float(sum(map(Fraction, VALS)))


def test_vector_pipeline_across_both_clis(keyfiles, tmp_path):
    """encryptvec -> addvec -> addencvec -> multiplyvec, alternating the
    CLIs: both decrypt the end to the same exactly rounded list."""
    priv_file, pub_file = keyfiles
    vals, plain, _ = (tmp_path / "v.json", tmp_path / "p.json", None)
    vals.write_text(json.dumps([1.5, -2.0, 4.0]))
    plain.write_text(json.dumps([10.0, 0.5, -1.0]))
    enc = tmp_path / "enc.json"
    _run(tcli, ["encryptvec", str(pub_file), str(vals), "--output",
                str(enc)], port=True)
    added = tmp_path / "added.json"
    _run(tcli, ["addvec", str(pub_file), str(enc), str(plain), "--output",
                str(added)], port=True)
    doubled = tmp_path / "doubled.json"
    _run(jcli, ["addencvec", str(pub_file), str(added), str(enc),
                "--output", str(doubled)])
    scaled = tmp_path / "scaled.json"
    _run(tcli, ["multiplyvec", str(pub_file), str(doubled), str(plain),
                "--output", str(scaled)], port=True)
    want = [float((2 * Fraction(v) + Fraction(p)) * Fraction(p))
            for v, p in zip([1.5, -2.0, 4.0], [10.0, 0.5, -1.0])]
    assert _decryptvec_both(priv_file, scaled) == want


def test_vector_commands_default_to_the_card(keyfiles, tmp_path, vector,
                                             monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pub_file = keyfiles
    vals, _, _ = vector
    result = CliRunner().invoke(tcli, ["encryptvec", str(pub_file),
                                       str(vals)])
    assert result.exit_code != 0
    assert "CUDA was requested" in str(result.exception)
