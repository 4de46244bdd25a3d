"""esslint for the port: its serve contracts, checked.

* :mod:`repro_torch.analysis.contracts` — the table of contracts, under
  the reference's rule names;
* :mod:`repro_torch.analysis.lint` — AST rules ESS001 (explicit gating
  keyword) and ESS002 (no host sync in a round, pack or install);
* :mod:`repro_torch.analysis.audit` — runtime audits ESS102 (one fetch a
  round), ESS103 (one capture per round variant), ESS104 (no state dtype
  drift), ESS106 (no tier-width dequant) and ESS107 (one wait a PD pack,
  none an install), each a pure checker beside a driver.

CLI: ``python -m repro_torch.analysis [--audit --device cpu]``.
"""

from repro_torch.analysis.findings import (Finding, load_baseline,
                                           write_baseline)

__all__ = ["Finding", "load_baseline", "write_baseline"]
