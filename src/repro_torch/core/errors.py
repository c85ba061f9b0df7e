"""Typed errors for the compression pipeline and the serving engine.

The serving hierarchy deliberately roots at :class:`ServingError` while the
submission-time rejections ALSO subclass ``ValueError``: every pre-existing
caller (and test) that caught ``ValueError`` around ``Engine.submit`` keeps
working, but new callers can discriminate shed-vs-invalid-vs-device failures
without string matching.
"""


class TechniqueInapplicable(Exception):
    """Raised when MergeMoE is requested for an architecture without routed
    experts (dense / ssm / hybrid / vlm / audio families). See DESIGN.md
    §Arch-applicability."""


class CalibrationError(Exception):
    """Raised when calibration data is insufficient (e.g. below the paper's
    critical sample threshold, Fig. 4) and the caller asked for strictness."""


# ---------------------------------------------------------------------------
# serving (DESIGN.md §12)
# ---------------------------------------------------------------------------

class ServingError(Exception):
    """Base class for engine-raised failures."""


class RequestValidationError(ServingError, ValueError):
    """A request that can never be served: rejected at SUBMISSION time (the
    only place the caller can react). Subclasses ``ValueError`` for
    backward compatibility with callers that caught the old bare raises."""


class InvalidTokenError(RequestValidationError):
    """Prompt contains token ids outside ``[0, vocab_size)`` — these would
    silently clamp at the embedding gather and serve garbage."""


class DuplicateUidError(RequestValidationError):
    """A submitted uid collides with a pending/active request. In-flight
    uids must be unique: the sampling key is ``fold_in(base, uid)``
    (DESIGN.md §10), so duplicates alias the Gumbel noise stream and two
    supposedly independent sampled generations become bitwise identical."""


class QueueFullError(ServingError):
    """Bounded pending queue is full and the backpressure policy could not
    make room (DESIGN.md §12 shed policy)."""


class DeviceStepError(ServingError):
    """A device step kept failing past the engine's bounded retry budget."""


class NumericHealthError(ServingError):
    """Strict-mode numeric sentinel: a slot produced non-finite logits
    (DESIGN.md §12). In ``count`` mode the engine quarantines the slot
    instead of raising."""


class ArtifactCorruptError(ServingError):
    """A checkpoint's recomputed ``tree_digest`` does not match the digest
    recorded in ``meta.json`` at save time — the artifact bytes were
    corrupted between save and load. Pass ``verify=False`` to load anyway
    (forensics only; never serve an unverified artifact)."""
