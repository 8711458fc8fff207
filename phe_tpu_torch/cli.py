"""pheutil-compatible command line for the port, on the GPU.

The port of phe_tpu/cli.py: the same thirteen commands and wire formats as
the reference CLI (phe/command_line.py:16-280): genpkey / extract /
encrypt / decrypt / add / addenc / multiply with JWK-style JSON keys and
{"v","e"} ciphertexts (exponent pinned to -32), host-only; and the
batch-first vector commands encryptvec / decryptvec / addvec / addencvec /
multiplyvec / sumvec, each one EncryptedBatch on the card.

One group option beyond phe_tpu's: ``--device`` (default ``cuda``), the
``device=`` argument of the port's batch entry points, where the vector
commands run. ``--device cpu`` runs their plain PyTorch versions.

Entry point: ``python -m phe_tpu_torch.cli [--device cpu] <command> ...``
"""

import json

import click

import phe_tpu_torch
from phe_tpu_torch import serial
from phe_tpu_torch.__about__ import __version__


def log(m, color="red"):
    click.echo(click.style(m, fg=color), err=True)


@click.group("pheutil")
@click.version_option(__version__, prog_name="pheutil")
@click.option("--verbose", "-v", is_flag=True, help="Chattier stderr logging.")
@click.option("--device", default="cuda", show_default=True,
              help="Torch device of the vector commands' batches.")
@click.pass_context
def cli(ctx, verbose=False, device="cuda"):
    """Paillier key/ciphertext tool (wire-compatible with pheutil)."""
    ctx.obj = device


@cli.command("genpkey")
@click.argument("output", type=click.File("w"))
@click.option("--keysize", type=int, default=2048,
              help="Modulus size in bits (default 2048).")
@click.option("--id", type=str, default=None,
              help="Free-form comment stored alongside the key.")
def generate_keypair(keysize, id, output):
    """Generate a Paillier private key as JWK JSON ("-" for stdout)."""
    log("Generating a {}-bit Paillier keypair...".format(keysize))
    pub, priv = phe_tpu_torch.generate_paillier_keypair(n_length=keysize)
    log("Keypair ready")
    json.dump(serial.private_key_to_jwk(priv), output)
    output.write("\n")
    log("Private key written to {}".format(output.name))


@cli.command()
@click.argument("input", type=click.File("r"))
@click.argument("output", type=click.File("w"))
def extract(input, output):
    """Write just the public half of a private key file."""
    log("Reading private key file")
    priv = json.load(input)
    bad = "not a pheutil private key (missing pub/kty fields)"
    assert "pub" in priv, bad
    assert priv["kty"] == "DAJ", bad
    json.dump(priv["pub"], output)
    output.write("\n")
    log("Public key written to {}".format(output.name))


@cli.command()
@click.argument("public", type=click.File("r"))
@click.argument("plaintext", type=str)
@click.option("--output", type=click.File("w"),
              help="Destination file (stdout if omitted).")
def encrypt(public, plaintext, output=None):
    """Encrypt one number (parsed as float) under a public key.

    Prefix negative values with a "--" separator.
    """
    num = float(plaintext)
    log("Reading public key")
    pub = serial.public_key_from_jwk(json.load(public))
    log("Encrypting {:+.16f}".format(num))
    enc = pub.encrypt(num)
    print(json.dumps(serial.dump_encrypted_number(enc)), file=output)


@cli.command()
@click.argument("private", type=click.File("r"))
@click.argument("ciphertext", type=click.File("r"))
@click.option("--output", type=click.File("w"),
              help="Destination file (stdout if omitted).")
def decrypt(private, ciphertext, output):
    """Recover the plaintext of a ciphertext file using a private key."""
    log("Reading private key")
    priv = serial.private_key_from_jwk(json.load(private))
    log("Decrypting")
    enc = serial.load_encrypted_number(
        json.load(ciphertext), priv.public_key
    )
    print(priv.decrypt(enc), file=output)


@cli.command("addenc")
@click.argument("public", type=click.File("r"))
@click.argument("encrypted_a", type=click.File("r"))
@click.argument("encrypted_b", type=click.File("r"))
@click.option("--output", type=click.File("w"),
              help="Destination file (stdout if omitted).")
def add_encrypted(public, encrypted_a, encrypted_b, output):
    """Homomorphic sum of two ciphertext files."""
    log("Reading public key")
    pub = serial.public_key_from_jwk(json.load(public))
    enc_a = serial.load_encrypted_number(json.load(encrypted_a), pub)
    enc_b = serial.load_encrypted_number(json.load(encrypted_b), pub)
    log("Combining the two ciphertexts")
    print(json.dumps(serial.dump_encrypted_number(enc_a + enc_b)), file=output)


@cli.command("add")
@click.argument("public", type=click.File("r"))
@click.argument("encrypted", type=click.File("r"))
@click.argument("plaintext", type=str)
@click.option("--output", type=click.File("w"),
              help="Destination file (stdout if omitted).")
def add_plain(public, encrypted, plaintext, output):
    """Homomorphically add a plaintext number into a ciphertext."""
    log("Reading public key")
    pub = serial.public_key_from_jwk(json.load(public))
    enc = serial.load_encrypted_number(json.load(encrypted), pub)
    num = float(plaintext)
    log("Adding {}".format(num))
    print(json.dumps(serial.dump_encrypted_number(enc + num)), file=output)


@cli.command("multiply")
@click.argument("public", type=click.File("r"))
@click.argument("encrypted", type=click.File("r"))
@click.argument("plaintext", type=str)
@click.option("--output", type=click.File("w"),
              help="Destination file (stdout if omitted).")
def multiply_plain(public, encrypted, plaintext, output):
    """Homomorphically scale a ciphertext by a plaintext number."""
    log("Reading public key")
    pub = serial.public_key_from_jwk(json.load(public))
    enc = serial.load_encrypted_number(json.load(encrypted), pub)
    num = float(plaintext)
    log("Scaling by {}".format(num))
    print(json.dumps(serial.dump_encrypted_number(enc * num)), file=output)


# -- batch-first extensions (the card) --------------------------------------


@cli.command("encryptvec")
@click.argument("public", type=click.File("r"))
@click.argument("values", type=click.File("r"))
@click.option("--output", type=click.File("w"),
              help="Destination file (stdout if omitted).")
@click.pass_obj
def encrypt_vector(device, public, values, output):
    """Encrypt a JSON array of numbers as one device batch."""
    from phe_tpu_torch.batch import EncryptedBatch

    pub = serial.public_key_from_jwk(json.load(public))
    nums = [float(v) for v in json.load(values)]
    log("Encrypting a batch of {} values".format(len(nums)))
    batch = EncryptedBatch.encrypt(pub, nums, device=device)
    print(json.dumps(serial.dump_encrypted_batch(batch)), file=output)


@cli.command("decryptvec")
@click.argument("private", type=click.File("r"))
@click.argument("ciphertexts", type=click.File("r"))
@click.option("--output", type=click.File("w"),
              help="Destination file (stdout if omitted).")
@click.pass_obj
def decrypt_vector(device, private, ciphertexts, output):
    """Decrypt a serialised encrypted vector as one device batch."""
    priv = serial.private_key_from_jwk(json.load(private))
    batch = serial.load_encrypted_batch(
        json.load(ciphertexts), priv.public_key, device=device
    )
    log("Decrypting a batch of {} values".format(len(batch)))
    print(json.dumps(batch.decrypt(priv)), file=output)


@cli.command("addvec")
@click.argument("public", type=click.File("r"))
@click.argument("ciphertexts", type=click.File("r"))
@click.argument("plainvec", type=click.File("r"))
@click.option("--output", type=click.File("w"),
              help="Destination file (stdout if omitted).")
@click.pass_obj
def add_vector(device, public, ciphertexts, plainvec, output):
    """Elementwise add a JSON array of numbers to an encrypted vector."""
    pub = serial.public_key_from_jwk(json.load(public))
    batch = serial.load_encrypted_batch(json.load(ciphertexts), pub,
                                         device=device)
    nums = [float(v) for v in json.load(plainvec)]
    log("Adding {} plaintext values".format(len(nums)))
    print(json.dumps(serial.dump_encrypted_batch(batch + nums)), file=output)


@cli.command("addencvec")
@click.argument("public", type=click.File("r"))
@click.argument("encrypted_a", type=click.File("r"))
@click.argument("encrypted_b", type=click.File("r"))
@click.option("--output", type=click.File("w"),
              help="Destination file (stdout if omitted).")
@click.pass_obj
def add_encrypted_vector(device, public, encrypted_a, encrypted_b, output):
    """Elementwise add two serialised encrypted vectors."""
    pub = serial.public_key_from_jwk(json.load(public))
    a = serial.load_encrypted_batch(json.load(encrypted_a), pub,
                                     device=device)
    b = serial.load_encrypted_batch(json.load(encrypted_b), pub,
                                     device=device)
    log("Adding two encrypted vectors of {}".format(len(a)))
    print(json.dumps(serial.dump_encrypted_batch(a + b)), file=output)


@cli.command("multiplyvec")
@click.argument("public", type=click.File("r"))
@click.argument("ciphertexts", type=click.File("r"))
@click.argument("plainvec", type=click.File("r"))
@click.option("--output", type=click.File("w"),
              help="Destination file (stdout if omitted).")
@click.pass_obj
def multiply_vector(device, public, ciphertexts, plainvec, output):
    """Elementwise multiply an encrypted vector by a JSON array of numbers."""
    pub = serial.public_key_from_jwk(json.load(public))
    batch = serial.load_encrypted_batch(json.load(ciphertexts), pub,
                                         device=device)
    nums = [float(v) for v in json.load(plainvec)]
    log("Multiplying by {} plaintext values".format(len(nums)))
    print(json.dumps(serial.dump_encrypted_batch(batch * nums)), file=output)


@cli.command("sumvec")
@click.argument("public", type=click.File("r"))
@click.argument("ciphertexts", type=click.File("r"))
@click.option("--output", type=click.File("w"),
              help="Destination file (stdout if omitted).")
@click.pass_obj
def sum_vector(device, public, ciphertexts, output):
    """Homomorphically sum a serialised encrypted vector on device."""
    pub = serial.public_key_from_jwk(json.load(public))
    batch = serial.load_encrypted_batch(json.load(ciphertexts), pub,
                                         device=device)
    log("Summing a batch of {} values".format(len(batch)))
    total = batch.sum().to_encrypted_numbers(be_secure=False)[0]
    print(json.dumps(serial.dump_encrypted_number(total)), file=output)


if __name__ == "__main__":
    cli()
