"""Seconds of audio transcribed per second: the audio of every file
completed, over the time from the window's opening to the last
completion."""


def read(rec):
    if rec.kind != "longform" or not rec.files:
        return None
    return sum(f.audio_s for f in rec.files) / rec.window_end
