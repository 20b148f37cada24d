"""Built-in single-file web UI served at /ui: the port's copy of
vision_compression_project_tpu/serve/ui.py.

Covers the reference frontend's workflow (upload PDF -> ingest -> chat with
evidence panel, reference frontend/app/page.tsx:32-431) without a build
step; the reference's Next.js app also works unchanged against this server
since the API surface is identical.
"""

UI_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>Vision Compression Document QA</title>
<style>
  :root { --bg:#0b0f17; --card:#141a26; --line:#26304a; --text:#e6ebf5;
          --dim:#8b97b0; --accent:#4f7cff; }
  * { box-sizing:border-box; }
  body { margin:0; font:15px/1.5 system-ui, sans-serif; background:var(--bg);
         color:var(--text); }
  .wrap { max-width:1100px; margin:0 auto; padding:24px; display:grid;
          grid-template-columns: 2fr 1fr; gap:16px; }
  h1 { grid-column:1/-1; font-size:20px; margin:0 0 4px; }
  .status { grid-column:1/-1; color:var(--dim); font-size:13px; }
  .card { background:var(--card); border:1px solid var(--line);
          border-radius:10px; padding:16px; }
  .card h2 { margin:0 0 10px; font-size:14px; color:var(--dim);
             text-transform:uppercase; letter-spacing:.06em; }
  input[type=file], input[type=number], textarea {
    width:100%; background:#0d1320; color:var(--text);
    border:1px solid var(--line); border-radius:6px; padding:8px; }
  button { background:var(--accent); color:white; border:0; border-radius:6px;
           padding:8px 16px; cursor:pointer; margin-top:8px; }
  button:disabled { opacity:.5; cursor:default; }
  .chat { min-height:200px; max-height:420px; overflow-y:auto; margin:10px 0;
          display:flex; flex-direction:column; gap:8px; }
  .msg { padding:10px 12px; border-radius:8px; white-space:pre-wrap; }
  .q { background:#1d2a45; align-self:flex-end; }
  .a { background:#101624; border:1px solid var(--line); }
  .ev { font-size:13px; border-top:1px solid var(--line); padding:8px 0; }
  .ev b { color:var(--accent); }
  .dim { color:var(--dim); font-size:13px; }
  .row { display:flex; gap:8px; }
  .row > * { flex:1; }
</style>
</head>
<body>
<div class="wrap">
  <h1>Vision Compression Document QA</h1>
  <div class="status" id="status">checking backend…</div>
  <div class="card" style="grid-column:1/-1">
    <h2>Ingest PDF</h2>
    <div class="row">
      <input type="file" id="pdf" accept="application/pdf">
      <input type="number" id="dpi" value="150" title="DPI">
      <button id="ingest">Ingest</button>
    </div>
    <div class="dim" id="ingestResult"></div>
  </div>
  <div class="card">
    <h2>Chat</h2>
    <div class="chat" id="chat"></div>
    <textarea id="question" rows="2" placeholder="Ask about the document…"></textarea>
    <div class="row">
      <input type="number" id="topk" value="8" title="Top-K">
      <input type="number" id="maxchars" value="1500" title="Max chars/page">
      <button id="ask" disabled>Ask</button>
    </div>
  </div>
  <div class="card">
    <h2>Evidence</h2>
    <div id="evidence" class="dim">No retrieval yet.</div>
  </div>
</div>
<script>
const $ = id => document.getElementById(id);
const esc = s => String(s).replace(/[&<>"']/g,
  c => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
let docId = null;
fetch('/health').then(r=>r.json()).then(j=>{
  $('status').textContent = j.ok ? 'backend healthy' : 'backend unhealthy';
}).catch(()=> $('status').textContent = 'backend unreachable');

$('ingest').onclick = async () => {
  const f = $('pdf').files[0];
  if (!f) return alert('choose a PDF');
  $('ingest').disabled = true;
  $('ingestResult').textContent = 'ingesting…';
  const fd = new FormData();
  fd.append('file', f);
  fd.append('dpi', $('dpi').value);
  try {
    const r = await fetch('/ingest', {method:'POST', body:fd});
    const j = await r.json();
    if (!r.ok) throw new Error(j.detail || r.status);
    docId = j.doc_id;
    // Ingest-result card mirroring the reference UI's: doc_id, ingested/total,
    // and a per-page failed list with errors (reference page.tsx:259-283).
    let html = `doc_id=<code>${esc(j.doc_id)}</code> · ` +
      `${j.pages_ingested}/${j.pages_total} pages ingested`;
    if (j.failed_pages.length) {
      html += `<div><b>Failed pages:</b><ul>` +
        j.failed_pages.map(p=>`<li>Page ${p.page}: ${esc(p.error)}</li>`).join('') +
        `</ul></div>`;
    }
    $('ingestResult').innerHTML = html;
    $('ask').disabled = false;
  } catch (e) { $('ingestResult').textContent = 'error: ' + e.message; }
  $('ingest').disabled = false;
};

$('ask').onclick = async () => {
  const q = $('question').value.trim();
  if (!q || !docId) return;
  const chat = $('chat');
  chat.insertAdjacentHTML('beforeend', `<div class="msg q"></div>`);
  chat.lastChild.textContent = q;
  $('question').value = '';
  $('ask').disabled = true;
  try {
    const r = await fetch('/chat', {method:'POST',
      headers:{'Content-Type':'application/json'},
      body: JSON.stringify({doc_id: docId, question: q,
        top_k: +$('topk').value, max_chars_per_page: +$('maxchars').value})});
    const j = await r.json();
    if (!r.ok) throw new Error(j.detail || r.status);
    chat.insertAdjacentHTML('beforeend', `<div class="msg a"></div>`);
    chat.lastChild.textContent = j.answer_md;
    $('evidence').innerHTML = j.retrieved.length ?
      j.retrieved.map(e=>`<div class="ev"><b>Page ${e.page}</b> ` +
        `<span class="dim">${esc(e.memory_id.slice(0,8))}</span><br>` +
        `${esc(e.excerpt)}</div>`).join('')
      : 'No evidence returned.';
  } catch (e) {
    chat.insertAdjacentHTML('beforeend', `<div class="msg a"></div>`);
    chat.lastChild.textContent = 'error: ' + e.message;
  }
  chat.scrollTop = chat.scrollHeight;
  $('ask').disabled = false;
};
</script>
</body>
</html>
"""
