"""The C99 sliding-panel MMQR oracle (host code), built at first use."""
