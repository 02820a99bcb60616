"""Self-signed certificate fixtures for TLS tests and demos.

Generates a throwaway CA plus a server (and optionally client) certificate
signed by it, written as PEM files — the loopback counterpart of the
reference's TlsConfig (enterprise.rs:786,874), which was config-only and
never wired into a listener.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

__all__ = ["make_test_certs"]


def _make_key():
    from cryptography.hazmat.primitives.asymmetric import rsa

    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


def _name(cn: str):
    from cryptography import x509
    from cryptography.x509.oid import NameOID

    return x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])


def make_test_certs(out_dir: str, server_cn: str = "localhost",
                    with_client: bool = False) -> dict:
    """Write ca.pem, server.pem, server.key (and client.pem/client.key) under
    out_dir; returns their paths. Certificates carry SANs for localhost and
    127.0.0.1 so loopback verification passes."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization

    import ipaddress

    os.makedirs(out_dir, exist_ok=True)
    now = datetime.datetime.now(datetime.timezone.utc)
    one_day = datetime.timedelta(days=1)

    ca_key = _make_key()
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(_name("gvdb-test-ca"))
        .issuer_name(_name("gvdb-test-ca"))
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - one_day)
        .not_valid_after(now + one_day * 365)
        .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                       critical=True)
        .sign(ca_key, hashes.SHA256())
    )

    def leaf(cn: str, key):
        return (
            x509.CertificateBuilder()
            .subject_name(_name(cn))
            .issuer_name(ca_cert.subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - one_day)
            .not_valid_after(now + one_day * 365)
            .add_extension(
                x509.SubjectAlternativeName([
                    x509.DNSName("localhost"),
                    x509.DNSName(cn),
                    x509.IPAddress(ipaddress.ip_address("127.0.0.1")),
                ]),
                critical=False,
            )
            .sign(ca_key, hashes.SHA256())
        )

    def write(path: str, data: bytes) -> str:
        with open(path, "wb") as f:
            f.write(data)
        return path

    pem = serialization.Encoding.PEM
    key_fmt = dict(
        encoding=pem,
        format=serialization.PrivateFormat.TraditionalOpenSSL,
        encryption_algorithm=serialization.NoEncryption(),
    )

    srv_key = _make_key()
    srv_cert = leaf(server_cn, srv_key)
    out = {
        "ca": write(os.path.join(out_dir, "ca.pem"),
                    ca_cert.public_bytes(pem)),
        "cert": write(os.path.join(out_dir, "server.pem"),
                      srv_cert.public_bytes(pem)),
        "key": write(os.path.join(out_dir, "server.key"),
                     srv_key.private_bytes(**key_fmt)),
    }
    if with_client:
        cl_key = _make_key()
        cl_cert = leaf("gvdb-test-client", cl_key)
        out["client_cert"] = write(os.path.join(out_dir, "client.pem"),
                                   cl_cert.public_bytes(pem))
        out["client_key"] = write(os.path.join(out_dir, "client.key"),
                                  cl_key.private_bytes(**key_fmt))
    return out
