"""Mean host ms a tick in ``insert_audio_chunk`` and ``process_iter`` outside the ASR's dispatch and finalize calls."""

from portbench.core import readers as R


def read(run):
    return R.host_ms(run)
