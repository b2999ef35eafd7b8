"""Prompt templates (reference ``xpacks/llm/prompts.py``)."""

from __future__ import annotations


def prompt_qa(query: str, docs: list[str], additional_rules: str = "") -> str:
    context = "\n".join(str(d) for d in docs)
    return (
        "Use the below documents to answer the question. If you can't find the "
        "answer in the documents, reply with 'No information found.'"
        f"{additional_rules}\n\nDocuments:\n{context}\n\nQuestion: {query}\nAnswer:"
    )


def prompt_qa_geometric_rag(query: str, docs: list[str], strict_prompt: bool = False) -> str:
    context = "\n".join(f"- {d}" for d in docs)
    base = (
        "Answer the question based only on the documents below. "
        "If the documents don't contain the answer, reply with exactly "
        "'No information found.'\n"
    )
    if strict_prompt:
        base += "Reply with only the shortest possible answer, no explanations.\n"
    return f"{base}\nDocuments:\n{context}\n\nQuestion: {query}\nAnswer:"


def prompt_summarize(texts: list[str]) -> str:
    joined = "\n".join(str(t) for t in texts)
    return f"Summarize the following texts into a single concise summary:\n{joined}\nSummary:"


NO_INFO_RESPONSE = "No information found."
