"""Streaming (incremental) fingerprint extraction + identification runtime."""

from lbaudiodetective.streaming.identify import (StreamingIdentifier,
                                                 StreamMatch)
from lbaudiodetective.streaming.runtime import StreamingExtractor, StreamingDetective

__all__ = ["StreamingExtractor", "StreamingDetective", "StreamingIdentifier",
           "StreamMatch"]
