"""Secrecy-domain labels: the type vocabulary of the seclint analyzer.

COPML's security argument is a discipline the Python type system never
sees: secret values exist only as Shamir shares or LCC-coded slices, may
be combined only through exact mod-p field ops, and may be *opened* only
at the protocol's sanctioned decode points (share reconstruction, the
Phase-4 gradient decode, the final model opening).  These aliases make
that discipline visible in annotations, with the same names as the JAX
package's labels, whose static analyzer (seclint) reads them as the ground
truth for taint seeding and for what a function is allowed to return.

All aliases are plain `torch.Tensor` at runtime -- zero cost, no wrappers;
they exist for humans and for the AST analyzer.

  Share       Shamir secret-shares of a protocol value (client axis
              leading, by convention).  Individual shares may be
              exchanged between clients, but the underlying secret may
              only be recovered through `shamir.reconstruct*` /
              `mpc.open_shares`.
  Coded       an LCC-coded slice (Lagrange evaluation of data + mask
              blocks).  Hides the data against any T colluding clients;
              still secret -- decodable only through `lagrange.lcc_decode`
              or the Phase-4 decode row (`Copml._fused_iteration`,
              `_RankStep.decode_update`).
  SecretRand  dealer/offline randomness (sharing-polynomial coefficients,
              LCC mask blocks, TruncPr pads).  Leaking it breaks the
              hiding argument exactly like leaking a secret.
  Public      a field-domain array that is public protocol state
              (Lagrange/power matrices, decode rows, quantized public
              constants).  Field rules still apply (exact mod-p
              arithmetic); secrecy rules do not.
  Opened      the result of a *sanctioned* declassification: a value
              that has passed through a registered decode point and is
              intentionally public (e.g. the final dequantized model).
              Annotating a function `-> Opened` declares it a declassify
              sink -- seclint trusts it, so new `Opened` annotations on
              protocol code deserve review scrutiny.

Scalar secrecy does not decay through arithmetic: anything computed from
a Share/Coded/SecretRand value stays secret until a sanctioned sink.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:  # pragma: no cover -- runtime value is irrelevant
    import torch

    Array = torch.Tensor
else:
    Array = Any

# secret domains
Share = Array
Coded = Array
SecretRand = Array

# public domains
Public = Array
Opened = Array

#: every label name the analyzer recognizes in annotations
LABEL_NAMES = ("Share", "Coded", "SecretRand", "Public", "Opened")
