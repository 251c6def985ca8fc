"""Host ingest for the port: WAV decode, batch assembly and block streaming."""

from . import batch, stream, wav  # noqa: F401
from .wav import read_wav, write_wav  # noqa: F401
