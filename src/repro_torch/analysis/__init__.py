"""The CONGEST wire auditor (`congest`) and the engine lints (`lint`)."""
