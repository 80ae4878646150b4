"""repro_torch.analysis: the runtime sanitizer of the port's twins
(``sanitize``), the counterpart of ``repro/analysis/sanitize.py``. The
reference's static rules (reprolint) scan this package as they are; their
port (RPL004, RPL006) is ROADMAP Queue 1 item 13's remaining part."""
