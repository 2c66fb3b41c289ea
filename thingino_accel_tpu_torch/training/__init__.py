"""Training-side tools of the port: post-training quantization
(``ptq``). QAT is not ported (ROADMAP.md A.8)."""
