"""Regenerate the reference-result HDF5 fixtures from ``/root/reference``.

The reference ships four result files produced by its own (numba)
kernels — ``/root/reference/tests/mrbp_qmc/test-*-results.h5`` — the
only direct numerical bridge to the reference available in this image.
As committed there they are CORRUPTED: a CRLF -> LF text conversion was
applied to the binary files (the HDF5 signature reads ``\\x89HDF\\n``
instead of ``\\x89HDF\\r\\n``, and no ``\\r\\n`` pair survives anywhere).

This script documents the forensic recovery (run once; the recovered
files are committed under ``tests/fixtures/``):

1. The deleted-byte count per file equals ``eof_address - stored_size``
   from the v0 superblock (offset 40), so the recovery is exact-size.
2. ``test-vmc-results.h5`` / ``test-dmc-ssf-results.h5`` lost only the
   signature CR (brute force over all 2^4 LF subsets / eof arithmetic).
3. ``test-vmc-ssf-results.h5`` lost one more CR inside the
   ``fdk_imag/totals`` payload; candidates were scored by physics
   (``Im rho_0 == 0`` exactly, sane magnitudes) leaving two, and the
   wrong one decodes a byte-shifted float ``8e-233`` at (56, 34).
4. ``test-dmc-density-results.h5`` lost four more CRs.  A structural
   walk of the v1 object headers / SNOD / TREE / HEAP chain bracketed
   them; the decisive test pins each candidate by requiring the stored
   walker drift and energy slots to equal the model's own
   ``PhysicalFuncs.drift/energy`` of the stored positions (they match
   to ~1e-15 for every live walker in the correct restoration).

The recovered states therefore double as a kernel-parity certificate:
reference-numba-produced walker ensembles whose stored local energies
and drifts the JAX kernels reproduce to f64 round-off
(``tests/qmc_exec/test_reference_interop.py``).
"""
import pathlib
import sys

REFERENCE_DIR = pathlib.Path("/root/reference/tests/mrbp_qmc")
FIXTURES_DIR = pathlib.Path(__file__).parent

#: stored-coordinate positions of the LFs that were originally CRLF.
DELETIONS = {
    "test-vmc-results.h5": [4],
    "test-dmc-ssf-results.h5": [4],
    "test-vmc-ssf-results.h5": [4, 139088],
    "test-dmc-density-results.h5": [4, 31826, 32491, 39793, 53385],
}


def restore(raw: bytes, cr_positions) -> bytes:
    out = bytearray()
    last = 0
    for pos in sorted(cr_positions):
        out += raw[last:pos]
        out += b"\r"
        last = pos
    out += raw[last:]
    return bytes(out)


def main() -> int:
    import h5py
    import io as _io

    for name, positions in DELETIONS.items():
        raw = (REFERENCE_DIR / name).read_bytes()
        fixed = restore(raw, positions)
        with h5py.File(_io.BytesIO(fixed), "r") as handle:
            count = []
            handle.visititems(lambda n, o: count.append(n))
        (FIXTURES_DIR / name).write_bytes(fixed)
        print(f"{name}: restored {len(positions)} CR bytes, "
              f"{len(count)} objects")
    return 0


if __name__ == "__main__":
    sys.exit(main())
