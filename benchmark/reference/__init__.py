"""The benchmark's plain reference decoder: a frozen copy of the plain
PyTorch versions of the port's steps (detector scan, front-end, downmix,
demodulator, frame and `RAW:` line arithmetic). It imports nothing of
the program and takes nothing it made: given the capture's samples and a
detector state, it works out the detections, the routing into burst
classes, the decoded frames and their lines itself (`decode.py`)."""
