"""Retrieval + cited-answer QA CLI: the port of scripts/qa_query.py.

Same argparse surface and answer-file format as the reference's
scripts/qa_with_supermemory_and_gemini.py (--question --manifest --top_k
--max_chars_per_page --model --rewrite_query; writes
output/answers/<YYYYMMDD_HHMMSS>_answer.md with '# Question / # Answer /
# Retrieved Pages (for debugging)' sections), with retrieval and
generation on the device. --rewrite_query replaces the reference's extra
Gemini round-trip with the model-based rewriter,
pipeline/qa.py::rewrite_query_learned."""

import argparse
import json
from datetime import datetime
from pathlib import Path

from ..pipeline import qa
from . import configure_logging


def save_answer(question: str, result: dict, answers_dir: Path) -> Path:
    """Answer file in the reference's exact format: Question / Answer
    sections, a '---' rule, then '# Retrieved Pages (for debugging)' with
    '- Page N: memory_id=M' lines."""
    answers_dir.mkdir(parents=True, exist_ok=True)
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    path = answers_dir / f"{timestamp}_answer.md"
    pages_list = "\n".join(
        f"- Page {r['page']}: memory_id={r['memory_id']}"
        for r in result["retrieved"]
    )
    content = (
        f"# Question\n\n{question}\n\n"
        f"# Answer\n\n{result['answer_md']}\n\n"
        f"---\n\n"
        f"# Retrieved Pages (for debugging)\n\n{pages_list}\n"
    )
    path.write_text(content, encoding="utf-8")
    return path


def main():
    parser = argparse.ArgumentParser(
        description="Question answering using on-device retrieval + generation with citations."
    )
    parser.add_argument("--question", required=True, help="Question to answer")
    parser.add_argument(
        "--manifest", default="output/supermemory_manifest.json",
        help="Path to ingest manifest (default: output/supermemory_manifest.json)",
    )
    parser.add_argument(
        "--top_k", type=int, default=8,
        help="Number of top results to retrieve (default: 8)",
    )
    parser.add_argument(
        "--max_chars_per_page", type=int, default=1500,
        help="Maximum characters per page in evidence pack (default: 1500)",
    )
    parser.add_argument(
        "--model", default=None,
        help="Answer engine override: extractive | lm (default: auto)",
    )
    parser.add_argument(
        "--rewrite_query", action="store_true",
        help="Rewrite the question into search phrases before retrieval",
    )
    args = parser.parse_args()
    configure_logging()

    manifest_path = Path(args.manifest)
    doc_id = None
    if manifest_path.exists():
        try:
            doc_id = json.loads(manifest_path.read_text(encoding="utf-8")).get("doc_id")
        except Exception:  # an unreadable manifest is reported below, as in the reference
            pass
    if not doc_id:
        print(f"Error: could not read doc_id from manifest {manifest_path}")
        raise SystemExit(1)

    question = args.question
    if args.rewrite_query:
        # Model-based rewrite: phrases scored by the serving embedder in the
        # index's own vector space.
        from ..pipeline.ingest import _get_embedder

        phrases = qa.rewrite_query_learned(question, _get_embedder())
        print(f"Rewritten query phrases: {phrases}")
        search_question = "; ".join(phrases)
    else:
        search_question = question

    result = qa.answer_question(
        doc_id=doc_id,
        question=search_question,
        top_k=args.top_k,
        max_chars_per_page=args.max_chars_per_page,
        manifest_path=manifest_path,
        engine=args.model,
    )
    # Present the original question in output even when rewritten.
    print("\n=== Answer ===\n")
    print(result["answer_md"])
    print("\n=== Retrieved ===")
    for r in result["retrieved"]:
        print(f"- page {r['page']} ({r['memory_id'][:8]}…)")
    path = save_answer(question, result, Path("output/answers"))
    print(f"\nSaved: {path}")


if __name__ == "__main__":
    main()
