"""Host-side media IO: PNG screenshots, ffmpeg video, recorder worker thread
(src/utils/recorder.rs)."""

from vokselis_torch.media.png import write_png
from vokselis_torch.media.recorder import Recorder, RecordEvent

__all__ = ["write_png", "Recorder", "RecordEvent"]
