"""Rule catalog and the sources / sinks / propagators registry.

Everything seclint believes about the world outside the file under
analysis lives here: which calls *create* secrets, which calls are
*sanctioned declassify sinks*, which calls merely move values around,
and which calls pull a value onto the host where a secret must never go.
The tables are keyed by fully-resolved dotted names (`repro_torch.core.shamir
.share`, `numpy.asarray`); `<prefix>.*` entries act as longest-prefix
wildcards.
"""

from __future__ import annotations

# --------------------------------------------------------------------------
# taint labels
# --------------------------------------------------------------------------

SHARE = "share"      # Shamir share of a secret
CODED = "coded"      # LCC-coded slice
RAND = "rand"        # dealer / offline randomness
FIELD = "field"      # value lives in the field domain F_p
REDUCED = "reduced"  # known canonical in [0, p)

SECRET = frozenset({SHARE, CODED, RAND})

#: annotation name -> label set (annotations are the analyzer's ground truth)
ANNOT_LABELS = {
    "Share": frozenset({SHARE, FIELD, REDUCED}),
    "Coded": frozenset({CODED, FIELD, REDUCED}),
    "SecretRand": frozenset({RAND, FIELD, REDUCED}),
    "Public": frozenset({FIELD, REDUCED}),
    "Opened": frozenset(),  # sanctioned declassification: no residual taint
}

#: the COPML field modulus; any other modulus literal >= SMALL_MOD_FLOOR
#: appearing as the right side of `%` is a foreign-modulus finding.
P_VALUE = (1 << 26) - 5
SMALL_MOD_FLOOR = 1 << 13  # `% 2`, `% block` index math stays exempt

# --------------------------------------------------------------------------
# rule catalog
# --------------------------------------------------------------------------

RULES = {
    "SEC001": "secret-tainted value reaches a host escape "
              "(.numpy() / np.asarray / int() / .item() / print / pickle)",
    "SEC002": "secret-dependent Python `if`/`while` "
              "(leak channel + jit-recompile hazard)",
    "SEC003": "secret-tainted value crosses into an unregistered "
              "external module without a sanctioned sink",
    "FLD001": "raw `+`/`-`/`*`/`@`/`%`/`**` on a field-domain array "
              "outside core/field.py / kernels/ wrappers",
    "FLD002": "narrowing dtype cast of a field value not dominated "
              "by a `% field.P` reduction",
    "FLD003": "float dtype touching a field-domain value",
    "FLD004": "modulus literal other than field.P",
    "WVR001": "malformed seclint waiver pragma",
    "WVR002": "unused seclint waiver pragma (strict mode only)",
    # --- commlint (the `comm` pass): choreography + comm-cost rules -------
    "COM001": "orphan send: a wire kind is sent but no matching recv "
              "site exists for the receiving role",
    "COM002": "unfulfillable recv: a wire kind is awaited but never "
              "sent by the declared sending role",
    "COM003": "cardinality/addressing mismatch: call site's peer-loop "
              "shape or peer role contradicts the round's declared legs",
    "COM004": "step/tag/phase discipline violation on a wire site or "
              "across a matched send/recv pair",
    "COM005": "choreography deadlock: missing barrier leg, "
              "uninstantiated round, or a recv-before-send cycle in "
              "the progress simulation",
    "COM006": "adaptive-collect violation: recv_any without a bounded "
              "timeout, or an adaptive round with no recv_any site",
    "COM007": "inventory failure: wire kind absent from the "
              "choreography spec, or spec/transport kind-table drift",
    "COM008": "pickle payload outside the registered control frames "
              "(LISTEN/SESSION/RESULT), or ad-hoc bytes on an array round",
    "COM009": "static frame budget divergence between the choreography "
              "spec and core/cost_model.proc_net_frames",
}

# --------------------------------------------------------------------------
# call effects
# --------------------------------------------------------------------------
# kind semantics (u = union of argument label sets):
#   source     -> labels | (u & SECRET)        creates a secret domain
#   open       -> (u - {share, rand}) | {field, reduced}   declassify sink
#   decode     -> (u - {coded}) | {field, reduced}         LCC decode sink
#   declassify -> {}                            fully sanctioned opening
#   fieldop    -> {field, reduced} | (u & SECRET)   exact mod-p wrapper
#   dequant    -> u - {field, reduced}          leaves the field domain
#   public     -> {field, reduced}              public field-domain constant
#   plain      -> {}                            no taint
#   propagate  -> u (dropping `reduced` if any field arg was unreduced)
#   escape     -> {} ; SEC001 if any argument is secret
#   replace    -> propagate + keep the dataclass type of arg 0

EFFECTS = {
    # --- field arithmetic: the wrappers ARE the sanctioned ops ------------
    "repro_torch.core.field.*": {"kind": "fieldop"},
    # explicit reduction sites (also in REDUCE_SITES below): their result
    # is canonical in [0, p), so a following narrowing cast passes FLD002
    "repro_torch.core.field.barrett_reduce": {"kind": "fieldop"},
    "repro_torch.core.field.fold26": {"kind": "fieldop"},
    "repro_torch.core.field.random_field": {
        "kind": "source", "labels": frozenset({RAND, FIELD, REDUCED})},
    "repro_torch.core.field.host_inv": {"kind": "public"},
    "repro_torch.core.field.host_lagrange_coeffs": {"kind": "public"},
    "repro_torch.core.field.host_lagrange_parts": {"kind": "public"},
    "repro_torch.core.field.host_inv_all": {"kind": "public"},

    # --- Shamir sharing ----------------------------------------------------
    "repro_torch.core.shamir.share": {
        "kind": "source", "labels": frozenset({SHARE, FIELD, REDUCED})},
    "repro_torch.core.shamir.share_batch": {
        "kind": "source", "labels": frozenset({SHARE, FIELD, REDUCED})},
    "repro_torch.core.shamir.reshare": {
        "kind": "source", "labels": frozenset({SHARE, FIELD, REDUCED})},
    "repro_torch.core.shamir.reconstruct": {"kind": "open"},
    "repro_torch.core.shamir.reconstruct_dyn": {"kind": "open"},
    "repro_torch.core.shamir.recon_weights": {"kind": "public"},
    "repro_torch.core.shamir.step_subset_arrays": {"kind": "public"},
    "repro_torch.core.shamir.*": {"kind": "public"},

    # --- MPC primitives ----------------------------------------------------
    "repro_torch.core.mpc.open_shares": {"kind": "open"},
    "repro_torch.core.mpc.*": {"kind": "fieldop"},

    # --- LCC coding ---------------------------------------------------------
    "repro_torch.core.lagrange.lcc_encode": {
        "kind": "source", "labels": frozenset({CODED, FIELD, REDUCED})},
    "repro_torch.core.lagrange._lcc_encode_with": {
        "kind": "source", "labels": frozenset({CODED, FIELD, REDUCED})},
    "repro_torch.core.lagrange.lcc_decode": {"kind": "decode"},
    "repro_torch.core.lagrange.encode_matrix": {"kind": "public"},
    "repro_torch.core.lagrange.decode_matrix": {"kind": "public"},
    "repro_torch.core.lagrange.*": {"kind": "propagate"},

    # --- quantization -------------------------------------------------------
    "repro_torch.core.quantize.quantize": {"kind": "fieldop"},
    "repro_torch.core.quantize.dequantize": {"kind": "dequant"},
    "repro_torch.core.quantize.signed_value": {"kind": "dequant"},
    "repro_torch.core.quantize.*": {"kind": "propagate"},

    # --- secure serving -----------------------------------------------------
    # open_logits is the serving path's ONLY sanctioned sink: it
    # reconstructs per-query logits (a (B, C') public output), never
    # anything model-shaped.  Everything else in serve/ stays in the
    # share domain and merely propagates taint.
    "repro_torch.serve.coded.open_logits": {"kind": "open"},
    "repro_torch.serve.coded.serving_points": {"kind": "public"},
    "repro_torch.serve.coded.reference_scores": {"kind": "public"},
    "repro_torch.serve.*": {"kind": "propagate"},

    # --- multi-process runtime ---------------------------------------------
    # share_payload is THE sanctioned cross-process sink: the runtime's
    # equivalent of `-> Opened` for sends.  Its output is an opaque wire
    # blob addressed to exactly one shareholder, so by the (t, N)-secrecy
    # argument it carries no residual taint; any OTHER serialization of a
    # share (`.numpy()`, `.tobytes()`, np.asarray, pickle) still flags
    # SEC001.
    "repro_torch.launch.runtime.wire.share_payload": {"kind": "declassify"},
    "repro_torch.launch.runtime.wire.pack_array": {"kind": "propagate"},
    "repro_torch.launch.runtime.*": {"kind": "propagate"},

    # --- everything else repro-internal ------------------------------------
    "repro_torch.core.truncation.*": {"kind": "propagate"},
    "repro_torch.core.meshutil.*": {"kind": "propagate"},
    "repro_torch.core.labels.*": {"kind": "plain"},
    "repro_torch.kernels.*": {"kind": "propagate"},
    "repro_torch.*": {"kind": "propagate"},

    # --- dataclasses --------------------------------------------------------
    "dataclasses.replace": {"kind": "replace"},
    "dataclasses.*": {"kind": "propagate"},

    # --- host escapes -------------------------------------------------------
    "numpy.asarray": {"kind": "escape"},
    "numpy.array": {"kind": "escape"},
    "numpy.save": {"kind": "escape"},
    "numpy.savez": {"kind": "escape"},
    "numpy.savetxt": {"kind": "escape"},
    "numpy.testing.*": {"kind": "escape"},
    "numpy.*": {"kind": "propagate"},
    "torch.save": {"kind": "escape"},
    "torch.*": {"kind": "propagate"},
    "pickle.*": {"kind": "escape"},
    "logging.*": {"kind": "escape"},
    "warnings.*": {"kind": "escape"},
    "builtins.print": {"kind": "escape"},
    "builtins.int": {"kind": "escape"},
    "builtins.float": {"kind": "escape"},
    "builtins.bool": {"kind": "escape"},
    "builtins.bytes": {"kind": "escape"},

    # --- misc stdlib that shows up in the hot path --------------------------
    "functools.*": {"kind": "propagate"},
    "itertools.*": {"kind": "propagate"},
    "math.*": {"kind": "plain"},
    "copy.*": {"kind": "propagate"},
    "operator.*": {"kind": "propagate"},
}

#: module roots that never count as a SEC003 boundary (registered above or
#: known-inert).  Anything else receiving a secret argument is a finding.
SAFE_ROOTS = frozenset({
    "repro_torch", "torch", "numpy", "builtins",
    "dataclasses", "functools", "itertools", "math", "copy", "operator",
    "typing", "collections", "abc", "enum", "contextlib",
    "os", "sys", "time", "argparse", "pathlib", "re", "string",
})

#: dotted prefixes that are known *modules* (not attributes), derived from
#: the EFFECTS keys.  Lets `from repro_torch.core import field` resolve
#: even when repro_torch itself is not part of the indexed tree (fixtures,
#: tmp copies).
KNOWN_MODULES = frozenset(
    key.rsplit(".", 1)[0] for key in EFFECTS if not key.endswith("*")
) | frozenset(
    key[:-2] for key in EFFECTS if key.endswith(".*")
) | frozenset({
    "torch.distributed", "torch.multiprocessing", "numpy.testing",
    "repro_torch.core", "repro_torch.kernels", "repro_torch.api",
    "repro_torch.core.protocol", "repro_torch.core.secure_agg",
    "repro_torch.core.baselines", "repro_torch.core.objectives",
    "repro_torch.launch", "repro_torch.launch.runtime",
})

# --------------------------------------------------------------------------
# array-method semantics (receiver of unknown type)
# --------------------------------------------------------------------------

#: methods that materialize on the host -> SEC001 when the receiver is
#: secret.  `.numpy()` hands torch's buffer to numpy (the JAX package's
#: np.asarray); `.cpu()` / `.to(device)` are NOT here: a copy between the
#: card and its host stays inside the one simulated party that holds the
#: value (the JAX package's device_put), so they propagate.
ESCAPE_METHODS = frozenset({"item", "tolist", "tobytes", "numpy"})

#: arithmetic reductions: stay in the field but lose canonicity
ARITH_METHODS = frozenset({
    "sum", "prod", "dot", "matmul", "cumsum", "cumprod",
    "mean", "var", "std", "trace",
})

#: attribute reads that are metadata, never data
META_ATTRS = frozenset({"shape", "dtype", "ndim", "size", "nbytes",
                        "itemsize", "device", "is_cuda"})

#: method calls whose result depends only on shapes, dtypes and the
#: layout, never on the values
META_METHODS = frozenset({"size", "dim", "numel", "stride", "element_size",
                          "is_contiguous", "storage_offset"})

#: cast targets: `.astype(t)` (numpy), `.to(t)` / `.type(t)` (torch)
NARROW_DTYPES = frozenset({"int32", "uint32", "int16", "uint16",
                           "int8", "uint8", "bool_", "bool", "int",
                           "short"})
FLOAT_DTYPES = frozenset({"float16", "float32", "float64", "float_",
                          "double", "bfloat16", "complex64", "complex128",
                          "float", "half"})
#: torch's cast methods with no argument, by their target
CAST_METHODS = {"int": "int32", "short": "int16", "char": "int8",
                "byte": "uint8", "bool": "bool", "float": "float32",
                "double": "float64", "half": "float16",
                "bfloat16": "bfloat16"}

# --------------------------------------------------------------------------
# FLD exemptions: these modules ARE the arithmetic layer (limb packing,
# bit-level folds) -- the FLD001/FLD002/FLD003 patterns are their job.
# FLD004 (foreign modulus) still applies everywhere.
# --------------------------------------------------------------------------

FLD_EXEMPT_SUFFIXES = ("core/field.py", "core/quantize.py")
FLD_EXEMPT_DIRS = ("kernels/",)


#: calls that ARE a full mod-p reduction.  Like the `% field.P` idiom,
#: passing an expression to one of these sanctions the raw `+`/`-`/`*`
#: arithmetic in its argument subtree (FLD001): the mu-multiply/shift and
#: q*p subtract inside barrett_reduce, or a lazy limb accumulation handed
#: to fold26, are the reduction itself, not an unreduced leak.  The
#: int32 magnitude bound is on the author, exactly as with `% field.P`.
REDUCE_SITES = frozenset({
    "repro_torch.core.field.barrett_reduce",
    "repro_torch.core.field.fold26",
})


def fld_exempt(relpath: str) -> bool:
    rel = relpath.replace("\\", "/")
    if rel.endswith(FLD_EXEMPT_SUFFIXES):
        return True
    return any(("/" + d) in rel or rel.startswith(d)
               for d in FLD_EXEMPT_DIRS)


def lookup_effect(dotted: str):
    """Longest-prefix effect lookup; None when the name is unregistered."""
    if dotted in EFFECTS:
        return EFFECTS[dotted]
    parts = dotted.split(".")
    for cut in range(len(parts) - 1, 0, -1):
        key = ".".join(parts[:cut]) + ".*"
        if key in EFFECTS:
            return EFFECTS[key]
    return None
