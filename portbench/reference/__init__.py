"""Plain PyTorch references of the measured pipelines. They import nothing
of the measured package and take nothing it made: the same depth frames
in, their own poses and maps out."""
