"""Docs hygiene: no dead links in the guide; code identifiers in docs exist.

Reference parity: tests/f_docs_no_dead_module_refs.rs +
f_docs_inference_examples.rs — documentation must not drift from the code.
"""

import os
import re

import fugue_tpu as ft

DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs")


def test_summary_links_resolve():
    summary = open(os.path.join(DOCS, "SUMMARY.md")).read()
    links = re.findall(r"\]\(([^)]+\.md)\)", summary)
    assert links, "SUMMARY.md has no links?"
    missing = [l for l in links if not os.path.exists(os.path.join(DOCS, l))]
    assert not missing, f"dead SUMMARY links: {missing}"


def test_doc_ft_identifiers_exist():
    """Every ``ft.NAME`` mentioned in the docs is a real export."""
    bad = []
    for root, _, files in os.walk(DOCS):
        for fn in files:
            if not fn.endswith(".md"):
                continue
            text = open(os.path.join(root, fn)).read()
            for name in set(re.findall(r"\bft\.([A-Za-z_][A-Za-z0-9_]*)", text)):
                if not hasattr(ft, name):
                    bad.append((fn, name))
    assert not bad, f"docs reference unknown fugue_tpu attributes: {bad}"


def test_readme_identifiers_exist():
    root = os.path.dirname(DOCS)
    text = open(os.path.join(root, "README.md")).read()
    for name in set(re.findall(r"\bft\.([A-Za-z_][A-Za-z0-9_]*)", text)):
        assert hasattr(ft, name), f"README references unknown ft.{name}"


def test_examples_reference_real_exports():
    root = os.path.dirname(DOCS)
    exdir = os.path.join(root, "examples")
    bad = []
    for fn in os.listdir(exdir):
        if not fn.endswith(".py"):
            continue
        text = open(os.path.join(exdir, fn)).read()
        for name in set(re.findall(r"\bft\.([A-Za-z_][A-Za-z0-9_]*)", text)):
            if not hasattr(ft, name):
                bad.append((fn, name))
    assert not bad, f"examples reference unknown attributes: {bad}"
