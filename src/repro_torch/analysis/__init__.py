"""The CONGEST wire auditor (`congest`), the engine lints (`lint`), and the
dry run's roofline model (`roofline`, with `hlo`'s collective parser)."""
