"""ERR fixture: exception-taxonomy violations (parsed, never imported)."""

import time

from repro_torch.runtime.faults import is_transient


def swallow_everything(work):
    try:
        return work()
    except Exception:  # expect[ERR]
        return None


def classify_ok(work):
    try:
        return work()
    except Exception as e:
        if not is_transient(e):
            raise
        return None


def reraise_ok(work):
    try:
        return work()
    except BaseException:
        raise


def retry_foreign_type(work):
    for _ in range(3):
        try:
            return work()
        except ValueError:  # expect[ERR]
            time.sleep(0.01)
    return None


def retry_taxonomy_ok(work):
    for _ in range(3):
        try:
            return work()
        except (OSError, TimeoutError):
            continue
    return None


def narrow_no_retry_ok(path):
    try:
        return open(path).read()
    except KeyError:
        return None


def allowed_swallow(work):
    try:
        return work()
    except Exception:  # repro: allow[ERR]: fixture — suppression must hold
        return None
