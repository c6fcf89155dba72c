"""Serving constants: a copy of ``unimp_tpu/serve/constants.py`` (the
reference's pipeline/constants.py:1-4)."""

CONTROLLER_HEART_BEAT_EXPIRATION = 90  # seconds without a beat -> dead
WORKER_HEART_BEAT_INTERVAL = 30
WORKER_API_TIMEOUT = 100
STREAM_DELIMITER = b"\0"  # reference model_worker.py chunk delimiter
SERVER_ERROR_MSG = (
    "**NETWORK ERROR DUE TO HIGH TRAFFIC. PLEASE REGENERATE OR REFRESH "
    "THIS PAGE.**"
)  # reference serving_utils.py:10-12
MODERATION_MSG = (
    "YOUR INPUT VIOLATES OUR CONTENT MODERATION GUIDELINES. PLEASE TRY AGAIN."
)  # reference serving_utils.py:13-15
